"""decode_walk.ms_per_MiB: milliseconds of device decode's device side per
MiB of output (the program's stages decode_walk, decode_resolve and
decode_crc)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("decode_walk", "decode_resolve", "decode_crc"), "out_mib")
