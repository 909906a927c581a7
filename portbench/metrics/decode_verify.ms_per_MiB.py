"""decode_verify.ms_per_MiB: milliseconds of device decode's CRC verdict on
the host, the copy back of the group CRCs included, per MiB of output
(the program's stages decode_verify)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("decode_verify",), "out_mib")
