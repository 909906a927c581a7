"""decode_MBps: 10^6 output bytes decoded onto the card per second of the
window, every call counted."""
from portbench.readers import rate_MBps


def read(rec):
    return rate_MBps(rec, 3)
