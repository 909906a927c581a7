"""zlib / gzip / raw container framing (host-side bytes).

The port's own copy of ``zzflate_tpu/utils/containers.py``: the writers
and the header parsers. Byte layouts follow RFC 1950/1952 as zlib 1.2.13
writes them.
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


def parse_gzip_index(
    data: bytes,
) -> (
    tuple[
        int, int, int,
        list[tuple[int, list[tuple[int, int]], list[tuple[int, int]]]],
    ]
    | None
):
    """Returns (header_len, chunk_bytes, anchor_tokens, chunks) for a ZZ
    v2/v3 subfield, chunks = [(seg_bytes, blocks, anchors), ...]. v2
    streams parse with empty anchors and anchor_tokens=0."""
    if len(data) < 10 or data[:2] != b"\x1f\x8b" or not (data[3] & 0x04):
        return None
    xlen = struct.unpack("<H", data[10:12])[0]
    extra = data[12 : 12 + xlen]
    header_len = parse_gzip_header(data)
    pos = 0
    while pos + 4 <= len(extra):
        sid = extra[pos : pos + 2]
        slen = struct.unpack("<H", extra[pos + 2 : pos + 4])[0]
        body = extra[pos + 4 : pos + 4 + slen]
        if sid == b"ZZ" and len(body) >= 10:
            ver, _flags, chunk_bytes, n = struct.unpack("<BBII", body[:10])
            if ver in (2, 3):
                p = 10
                anchor_tokens = 0
                if ver == 3:
                    if len(body) < 12:
                        pos += 4 + slen
                        continue
                    (anchor_tokens,) = struct.unpack("<H", body[10:12])
                    p = 12
                chunks = []
                ok = True
                for _ in range(n):
                    rec = 6 if ver == 2 else 8
                    if p + rec > len(body):
                        ok = False
                        break
                    if ver == 2:
                        seg_bytes, nb = struct.unpack(
                            "<IH", body[p : p + 6]
                        )
                        na = 0
                        p += 6
                    else:
                        seg_bytes, nb, na = struct.unpack(
                            "<IHH", body[p : p + 8]
                        )
                        p += 8
                    if p + 8 * (nb + na) > len(body):
                        ok = False
                        break
                    blocks = []
                    for _ in range(nb):
                        blocks.append(
                            struct.unpack("<II", body[p : p + 8])
                        )
                        p += 8
                    anchors = []
                    for _ in range(na):
                        anchors.append(
                            struct.unpack("<II", body[p : p + 8])
                        )
                        p += 8
                    chunks.append((seg_bytes, blocks, anchors))
                if ok:
                    return header_len, chunk_bytes, anchor_tokens, chunks
        pos += 4 + slen
    return None


def gzip_index_flags(data: bytes) -> int | None:
    """The 'ZZ' subfield's flags byte, or None if the stream carries no
    parseable index (parse_gzip_index returns the rest of the index)."""
    if len(data) < 12 or data[:2] != b"\x1f\x8b" or not (data[3] & 0x04):
        return None
    xlen = struct.unpack("<H", data[10:12])[0]
    extra = data[12 : 12 + xlen]
    pos = 0
    while pos + 4 <= len(extra):
        sid = extra[pos : pos + 2]
        slen = struct.unpack("<H", extra[pos + 2 : pos + 4])[0]
        body = extra[pos + 4 : pos + 4 + slen]
        if sid == b"ZZ" and len(body) >= 10 and body[0] in (2, 3):
            return body[1]
        pos += 4 + slen
    return None


def parse_zlib_header(data: bytes) -> tuple[int, int | None]:
    """Returns (header_len, dictid or None). Raises on malformed input."""
    if len(data) < 2:
        raise ValueError("truncated zlib header")
    cmf, flg = data[0], data[1]
    if cmf & 0x0F != 8:
        raise ValueError(f"unsupported compression method {cmf & 0x0F}")
    if (cmf * 256 + flg) % 31 != 0:
        raise ValueError("bad zlib header check")
    if flg & 0x20:
        if len(data) < 6:
            raise ValueError("truncated DICTID")
        return 6, struct.unpack(">I", data[2:6])[0]
    return 2, None


def parse_gzip_header(data: bytes) -> int:
    """Returns the header length. Handles optional FEXTRA/FNAME/FCOMMENT/FHCRC."""
    if len(data) < 10 or data[0] != 0x1F or data[1] != 0x8B:
        raise ValueError("bad gzip magic")
    if data[2] != 8:
        raise ValueError(f"unsupported gzip method {data[2]}")
    flg = data[3]
    pos = 10
    if flg & 0x04:  # FEXTRA
        if pos + 2 > len(data):
            raise ValueError("truncated FEXTRA length")
        xlen = struct.unpack("<H", data[pos : pos + 2])[0]
        pos += 2 + xlen
    if flg & 0x08:  # FNAME
        try:
            pos = data.index(b"\x00", pos) + 1
        except ValueError:
            raise ValueError("unterminated FNAME") from None
    if flg & 0x10:  # FCOMMENT
        try:
            pos = data.index(b"\x00", pos) + 1
        except ValueError:
            raise ValueError("unterminated FCOMMENT") from None
    if flg & 0x02:  # FHCRC
        pos += 2
    if pos > len(data):
        raise ValueError("truncated gzip header")
    return pos


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
# A final empty fixed-Huffman block (BFINAL=1, BTYPE=01, EOB), byte
# aligned: closes a stream whose segments were all written non-final.
FINAL_EMPTY_FIXED_BLOCK = b"\x03\x00"


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
