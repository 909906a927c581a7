"""decode_upload.ms_per_MiB: milliseconds of device decode's uploads per
MiB of output (the program's stages decode_upload)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("decode_upload",), "out_mib")
