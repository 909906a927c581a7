"""decode_plan.ms_per_MiB: milliseconds of device decode's host plan and
staging per MiB of output (the program's stages decode_plan)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("decode_plan",), "out_mib")
