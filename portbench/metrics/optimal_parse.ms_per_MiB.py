"""optimal_parse.ms_per_MiB: milliseconds of the host optimal parse (levels
7-9) per MiB of input (the program's stages optimal_parse)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("optimal_parse",), "in_mib")
