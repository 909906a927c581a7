"""zlib / gzip / raw container framing (host-side bytes).

The port's own copy of the writer half of ``zzflate_tpu/utils/containers.py``
(the header parsers belong to the decode slice). Byte layouts follow
RFC 1950/1952 as zlib 1.2.13 writes them.
"""
from __future__ import annotations

import struct

from zzflate_tpu_torch.constants import ANCHOR_TOKENS
from zzflate_tpu_torch.ops.checksums import adler32_combine, crc32_combine

ZLIB_FLEVEL = {0: 0, 1: 0, 2: 1, 3: 1, 4: 1, 5: 1, 6: 2, 7: 3, 8: 3, 9: 3}


def zlib_header(
    level: int, dictid: int | None = None, window_bits: int = 15
) -> bytes:
    cmf = ((window_bits - 8) << 4) | 8  # CM=8 (deflate), CINFO=log2(win)-8
    flg = ZLIB_FLEVEL.get(level, 2) << 6
    if dictid is not None:
        flg |= 0x20
    rem = (cmf * 256 + flg) % 31
    if rem:
        flg += 31 - rem
    out = bytes([cmf, flg])
    if dictid is not None:
        out += struct.pack(">I", dictid & 0xFFFFFFFF)
    return out


def zlib_trailer(adler: int) -> bytes:
    return struct.pack(">I", adler & 0xFFFFFFFF)


def gzip_header(mtime: int = 0) -> bytes:
    # magic, CM=8, FLG=0, MTIME (LE), XFL=0, OS=255 (unknown). mtime=0 =
    # "no timestamp" (RFC 1952 2.3.1) keeps outputs byte-reproducible.
    return b"\x1f\x8b\x08\x00" + struct.pack("<I", int(mtime) & 0xFFFFFFFF) \
        + b"\x00\xff"


# Indexed gzip: a 'ZZ' FEXTRA subfield describing the per-chunk segments
# (byte-aligned, sync-flush framed) and the bit offset + output offset of
# every deflate block inside them. Any standard gzip reader skips FEXTRA,
# so the stream stays a single valid gzip member (RFC 1952 2.3.1.1).
ZZ_INDEX_VERSION = 3

# SEEKABLE: every chunk was encoded with a window reset (no halo), so any
# chunk decodes from its own segment alone.
ZZ_FLAG_SEEKABLE = 1


def gzip_header_indexed(
    chunk_bytes: int,
    chunks: list[tuple[int, list[tuple[int, int]], list[tuple[int, int]]]],
    flags: int = 0,
) -> bytes:
    """chunks: [(seg_bytes, blocks, anchors), ...] where blocks and
    anchors are [(bit_off, out_off), ...] relative to the segment.

    v3 layout: ver(B) flags(B) chunk_bytes(I) nchunks(I) T(H), then per
    chunk: seg_bytes(I) nb(H) na(H) + nb block pairs + na anchor pairs.
    Anchors are dropped (na=0) if the index would not fit FEXTRA."""
    def build(with_anchors: bool) -> bytearray:
        sub = bytearray(
            struct.pack(
                "<BBIIH", ZZ_INDEX_VERSION, flags, chunk_bytes,
                len(chunks), ANCHOR_TOKENS if with_anchors else 0,
            )
        )
        for seg_bytes, blocks, anchors in chunks:
            a = anchors if with_anchors else []
            sub += struct.pack("<IHH", seg_bytes, len(blocks), len(a))
            for bit_off, out_off in blocks:
                sub += struct.pack("<II", bit_off, out_off)
            for bit_off, out_off in a:
                sub += struct.pack("<II", bit_off, out_off)
        return sub

    sub = build(True)
    if len(sub) > 65535 - 4:
        sub = build(False)  # anchors are an accelerator, not a contract
    if len(sub) > 65535 - 4:
        raise ValueError("too many chunks/blocks for an FEXTRA index")
    extra = b"ZZ" + struct.pack("<H", len(sub)) + bytes(sub)
    return (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + struct.pack("<H", len(extra))
        + extra
    )


def gzip_trailer(crc: int, isize: int) -> bytes:
    return struct.pack("<II", crc & 0xFFFFFFFF, isize & 0xFFFFFFFF)


def stored_segment(chunk: bytes, final: bool) -> bytes:
    """Byte-aligned stored blocks covering `chunk`.

    Assumes the write position is byte-aligned (the chunk framing
    guarantees it). Each block: 1 header byte (BFINAL + BTYPE=00 + 5 pad
    zero bits), LEN, NLEN, raw bytes.
    """
    out = bytearray()
    n = len(chunk)
    off = 0
    while True:
        piece = chunk[off : off + 65535]
        off += len(piece)
        last = off >= n
        out.append(0x01 if (final and last) else 0x00)
        ln = len(piece)
        out += struct.pack("<HH", ln, ln ^ 0xFFFF)
        out += piece
        if last:
            break
    return bytes(out)


SYNC_FLUSH_MARKER = b"\x00\x00\xff\xff"


def combine_adler(parts: list[tuple[int, int]]) -> int:
    """Combine (adler, length) shard checksums in order."""
    acc, _ = parts[0] if parts else (1, 0)
    for a, ln in parts[1:]:
        acc = adler32_combine(acc, a, ln)
    return acc


def combine_crc(parts: list[tuple[int, int]]) -> int:
    """Combine (crc, length) shard checksums in order."""
    acc = parts[0][0] if parts else 0
    for c, ln in parts[1:]:
        acc = crc32_combine(acc, c, ln)
    return acc
