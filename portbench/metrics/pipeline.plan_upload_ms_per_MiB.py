"""pipeline.plan_upload_ms_per_MiB: milliseconds of stacking the host plans and
copying them to the card per MiB of input (the program's stages
plan_upload)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("plan_upload",), "in_mib")
