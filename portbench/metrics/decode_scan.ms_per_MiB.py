"""decode_scan.ms_per_MiB: milliseconds of the foreign decode's host anchor
scan (native.scan_anchors over the whole deflate body: every block and
every 64th token's bit and output position) per MiB of output (the
program's stages decode_scan)."""
from portbench.readers import stages_per_mib


def read(rec):
    return stages_per_mib(rec, ("decode_scan",), "out_mib")
