"""decode_adler.ms_per_MiB: milliseconds of device decode's Adler-32 of a
zlib stream on the card (adler32_rows once a group, over the group's
output) per MiB of output (the program's stages decode_adler); None from
a program that computes no Adler-32 on the card."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("decode_adler",), "out_mib")
