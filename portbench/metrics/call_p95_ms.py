"""call_p95_ms: the 95th percentile of the wall time of every call in the
window."""
from portbench.readers import call_percentile_ms


def read(rec):
    return call_percentile_ms(rec, 95)
