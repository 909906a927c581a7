"""kernels.decode_roofline: percent of the device time of the decode
kernels that the cell's kind names (per-bit path: candidates, commit walk,
token scatter, resolve, CRC) that their least time from the cell's shapes
fills (bounds.decode_families)."""
from portbench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec)
