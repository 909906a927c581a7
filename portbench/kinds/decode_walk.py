"""Kind ``decode_walk``: ``kinds/decode.py``'s call,
``decompress_indexed(blob, to_device=True)`` with ``verify`` left on, over
shards small enough that the port's index keeps its anchors (the 'ZZ'
subfield's T is not 0), so the walk path runs: ``anchor_walk``, the LZ
resolve and the CRC, bounded as ``kinds/decode_foreign.py`` bounds them.
Set-up checks that every shard's index carries anchors."""
import struct

from portbench.kinds import decode, decode_foreign


def anchor_tokens(blob: bytes) -> int:
    """T, the anchor spacing, of the blob's 'ZZ' v3 subfield; 0 when the
    index dropped its anchors or the blob has none."""
    if len(blob) < 12 or not blob[3] & 0x04:
        return 0
    (xlen,) = struct.unpack_from("<H", blob, 10)
    extra = blob[12:12 + xlen]
    pos = 0
    while pos + 4 <= len(extra):
        (slen,) = struct.unpack_from("<H", extra, pos + 2)
        if extra[pos:pos + 2] == b"ZZ" and slen >= 12 and extra[pos + 4] == 3:
            return struct.unpack_from("<H", extra, pos + 14)[0]
        pos += 4 + slen
    return 0


class Traffic(decode.Traffic):
    FAMILIES = decode_foreign.Traffic.FAMILIES
    bound_ms = decode_foreign.Traffic.bound_ms

    def setup(self) -> None:
        super().setup()
        if not all(anchor_tokens(b) for b in self.blobs):
            raise RuntimeError("an index without anchors: the per-bit path "
                               "would run")


control = decode.control
