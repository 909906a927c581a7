"""device.launches_per_MiB.decode: kernels launched on the card per MiB of
output in the profiled calls."""
from portbench.readers import launches_per_mib


def read(rec):
    return launches_per_mib(rec, "out_mib")
