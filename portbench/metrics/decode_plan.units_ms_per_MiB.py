"""decode_plan.units_ms_per_MiB: milliseconds of device decode's block header
parse into canonical tables per MiB of output (the program's stages
decode_units)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("decode_units",), "out_mib")
