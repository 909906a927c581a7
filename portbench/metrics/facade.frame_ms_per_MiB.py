"""facade.frame_ms_per_MiB: milliseconds of the facade's framing per MiB of
input: the payload join, the stored fallback and the container (the
program's stages frame)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("frame",), "in_mib")
