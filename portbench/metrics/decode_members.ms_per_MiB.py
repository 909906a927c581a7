"""decode_members.ms_per_MiB: milliseconds of the host work the foreign gzip
decode spends on its members outside the C scan (the members' ISIZE
checks, the expected CRC, each block's end from its member's) per MiB of
output (the program's stages decode_members)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("decode_members",), "out_mib")
