"""encode_MBps: 10^6 input bytes compressed per second of the window, every
call counted."""
from portbench.readers import rate_MBps


def read(rec):
    return rate_MBps(rec, 2)
