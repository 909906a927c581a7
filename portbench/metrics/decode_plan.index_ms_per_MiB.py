"""decode_plan.index_ms_per_MiB: milliseconds of device decode's index parse,
checks and grouping per MiB of output (the program's stages
decode_index)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("decode_index",), "out_mib")
