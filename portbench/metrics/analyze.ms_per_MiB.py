"""analyze.ms_per_MiB: milliseconds of the device analyze per MiB of input
(the program's stages analyze_dispatch and analyze_fetch_freqs)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("analyze_dispatch", "analyze_fetch_freqs"), "in_mib")
