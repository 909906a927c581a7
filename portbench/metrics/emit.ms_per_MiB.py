"""emit.ms_per_MiB: milliseconds of the device emit and its fetch per MiB
of input (the program's stages emit_dispatch and emit_fetch)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("emit_dispatch", "emit_fetch"), "in_mib")
