"""The gzip member (RFC 1952) for the plain reference."""
from __future__ import annotations

import struct
import zlib

from portbench import reference

_FHCRC, _FEXTRA, _FNAME, _FCOMMENT = 2, 4, 8, 16


def header_len(blob: bytes) -> int:
    """Length of a gzip member's header (RFC 1952 2.3); ValueError when
    the header is malformed."""
    if len(blob) < 18 or blob[:3] != b"\x1f\x8b\x08":
        raise ValueError("not a gzip member with CM=8")
    flg = blob[3]
    if flg & 0xE0:
        raise ValueError("reserved FLG bits set")
    pos = 10
    if flg & _FEXTRA:
        (xlen,) = struct.unpack("<H", blob[pos:pos + 2])
        pos += 2 + xlen
    for bit in (_FNAME, _FCOMMENT):
        if flg & bit:
            end = blob.index(b"\x00", pos)
            pos = end + 1
    if flg & _FHCRC:
        (hcrc,) = struct.unpack("<H", blob[pos:pos + 2])
        if hcrc != zlib.crc32(blob[:pos]) & 0xFFFF:
            raise ValueError("header CRC mismatch")
        pos += 2
    if pos > len(blob) - 8:
        raise ValueError("header runs past the member")
    return pos


def body_bytes(blob: bytes) -> int:
    return len(blob) - header_len(blob) - 8


def zero_check(blob: bytes) -> bytes:
    """The member with its trailer's CRC-32 zeroed."""
    return blob[:-8] + bytes(4) + blob[-4:]


def fault(blob: bytes, data: bytes, window_bits: int) -> str | None:
    """Why `blob` is not a single gzip member of `data` at window_bits
    (None when it is): the header, the deflate data read back whole, the
    trailer's CRC-32 and ISIZE, nothing after the member."""
    try:
        start = header_len(blob)
        out, rest = reference.inflate_raw(blob[start:], window_bits)
    except (ValueError, IndexError, struct.error) as e:
        return str(e)
    if len(rest) != 8:
        return f"{len(rest)} bytes after the deflate data, not 8"
    crc, isize = struct.unpack("<II", rest)
    if crc != zlib.crc32(data):
        return "trailer CRC-32 differs from the input's"
    if isize != len(data) & 0xFFFFFFFF:
        return "trailer ISIZE differs from the input's length"
    if out != data:
        return "decodes to other bytes than the input"
    return None
