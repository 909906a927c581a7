"""device.launches_per_MiB.encode: kernels launched on the card per MiB of
input in the profiled calls."""
from portbench.readers import launches_per_mib


def read(rec):
    return launches_per_mib(rec, "in_mib")
