"""host_plan.blocks_ms_per_MiB: milliseconds of the host plan's block grouping
per MiB of input (the program's stages host_plan_blocks)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("host_plan_blocks",), "in_mib")
