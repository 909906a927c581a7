"""pipeline.batch_stitch_ms_per_MiB: milliseconds of batch staging and
stitching per MiB of input (the program's stages build_batches and
stitch)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("build_batches", "stitch"), "in_mib")
