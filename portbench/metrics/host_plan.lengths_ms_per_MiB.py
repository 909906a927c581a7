"""host_plan.lengths_ms_per_MiB: milliseconds of the host plan's literal/length
and distance code lengths per MiB of input (the program's stages
host_plan_lengths)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("host_plan_lengths",), "in_mib")
