"""host_plan.ms_per_MiB: milliseconds of the host Huffman plan per MiB of
input (the program's stages host_plan)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("host_plan",), "in_mib")
