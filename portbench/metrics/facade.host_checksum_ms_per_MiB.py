"""facade.host_checksum_ms_per_MiB: milliseconds of the container's
checksum pass over the input on the host per MiB of input (the program's
stages frame_checksum)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("frame_checksum",), "in_mib")
