"""decode_plan.pack_ms_per_MiB: milliseconds of device decode's numpy fill of
each group's inputs per MiB of output (the program's stages
decode_pack)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("decode_pack",), "out_mib")
