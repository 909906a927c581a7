"""host_plan.header_ms_per_MiB: milliseconds of the host plan's dynamic header
(code-length RLE, code-length code, field list) per MiB of input (the
program's stages host_plan_header)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("host_plan_header",), "in_mib")
