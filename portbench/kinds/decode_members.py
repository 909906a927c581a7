"""Kind ``decode_members``: one ``models.inflate_device.decompress_foreign(
blob, format="gzip", to_device=True)`` a call, ``verify`` left on,
synchronised, of a BGZF file: set-up writes each buffer as htslib's
``bgzip`` does (SAMv1 §4.1: raw deflate members of at most 0xff00 input
bytes at the configuration's level, windowBits -15, memLevel 8, each
header with FEXTRA's ``BC`` subfield holding BSIZE, MTIME 0, OS 255, and
the 28-byte empty member at the end), and reads it back member by member
with the standard library's ``zlib``, each member's CRC-32 and ISIZE
checked (``gzip.decompress`` copies the rest of the file once a member).
That is the function ``api.decompress(engine="device")`` reaches for such
a file; a file it declines (None) is a failed call, never a host decode.
Also reads ``check_sample`` (generator.DeviceDecodeTraffic); the answers
and the sample are compared as in ``kinds/decode.py``, and
``bad_crc_accepted`` flips the CRC-32 of the middle data member."""
import struct
import zlib

from portbench import bounds, generator
from portbench.kinds import decode_foreign

BLOCK = 0xFF00  # input bytes a member holds at most
MAX_MEMBER = 1 << 16  # BSIZE + 1 at most
FRAME = 26  # a member's header (18 B with the BC subfield) and trailer
EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def bgzf_members(buf: bytes, level: int) -> list[bytes]:
    """buf's BGZF members, the end marker last."""
    out = []
    for o in range(0, len(buf), BLOCK):
        piece = buf[o:o + BLOCK]
        c = zlib.compressobj(level, zlib.DEFLATED, -15, 8,
                             zlib.Z_DEFAULT_STRATEGY)
        body = c.compress(piece) + c.flush()
        out.append(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                   + struct.pack("<H2sHH", 6, b"BC", 2,
                                 len(body) + FRAME - 1)
                   + body + struct.pack("<II", zlib.crc32(piece),
                                        len(piece)))
    return out + [EOF]


def read_back(blob: bytes) -> bytes:
    """The file's bytes, member by member at the offsets BSIZE gives,
    each member's header, CRC-32 and ISIZE checked."""
    out, pos = [], 0
    while pos < len(blob):
        if blob[pos:pos + 16] != (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00"
                                  b"\xff\x06\x00BC\x02\x00"):
            raise ValueError(f"not a BGZF header at {pos}")
        end = pos + struct.unpack_from("<H", blob, pos + 16)[0] + 1
        piece = zlib.decompress(blob[pos + 18:end - 8], -15)
        if struct.unpack_from("<II", blob, end - 8) != (zlib.crc32(piece),
                                                        len(piece)):
            raise ValueError(f"trailer of the member at {pos}")
        out.append(piece)
        pos = end
    return b"".join(out)


class Traffic(decode_foreign.Traffic):
    def setup(self) -> None:
        c = self.codec
        if (c["format"], c["window_bits"], c["mem_level"],
                c["strategy"]) != ("gzip", 15, 8, 0):
            raise ValueError("bgzip writes gzip members at windowBits 15, "
                             "memLevel 8, default strategy")
        generator.DeviceDecodeTraffic.setup(self)  # the pool, on the card
        self.members = [bgzf_members(buf, c["level"]) for buf in self.pool]
        self.blobs = [b"".join(m) for m in self.members]
        for members, blob, buf in zip(self.members, self.blobs, self.pool):
            if any(len(m) > MAX_MEMBER for m in members):
                raise RuntimeError("a BGZF member over 64 KiB")
            if read_back(blob) != buf:
                raise RuntimeError("zlib does not read the members back")

    def bound_ms(self, i: int) -> dict[str, float]:
        """As kinds/decode_foreign.py's, the walk over the sum of the
        members' deflate bodies."""
        j = i % len(self.pool)
        body = sum(len(m) - FRAME for m in self.members[j])
        n = len(self.pool[j])
        return {"walk": bounds.least_ms(*bounds.walk_work(body, 0, 0, 0,
                                                          0))[0],
                "resolve": bounds.least_ms(*bounds.resolve_work(n))[0],
                "crc": bounds.least_ms(*bounds.checksum_work(
                    "crc32_rows", n, 1))[0]}

    def check(self, failed: int) -> dict[str, tuple[int, int]]:
        """Also bad_crc_accepted: 1 when the decoder accepts the pool's
        first file with the trailer CRC-32 of its middle data member (of
        n data members, member n // 2 from 0; never the end marker)
        altered, 0 when it raises ValueError."""
        checks = generator.DeviceDecodeTraffic.check(self, failed)
        members = self.members[0]
        k = (len(members) - 1) // 2
        off = sum(len(m) for m in members[:k + 1]) - 8
        blob = self.blobs[0]
        (crc,) = struct.unpack_from("<I", blob, off)
        bad = (blob[:off] + struct.pack("<I", crc ^ 0xFFFFFFFF)
               + blob[off + 4:])
        try:
            self._decode(bad)
            checks["bad_crc_accepted"] = (1, 0)
        except ValueError:
            checks["bad_crc_accepted"] = (0, 0)
        return checks


control = decode_foreign.control
