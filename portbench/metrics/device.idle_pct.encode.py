"""device.idle_pct.encode: percent of the profiled calls' span in which no
kernel or copy ran on the card."""
from portbench.readers import idle_pct


def read(rec):
    return idle_pct(rec)
