"""kernels.encode_roofline: percent of the device time of the matcher
kernels that the cell's kind names (scan, propagate, parse) that their
least time from the cell's shapes fills (bounds.encode_families)."""
from portbench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec)
