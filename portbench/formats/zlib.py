"""The zlib stream (RFC 1950) for the plain reference."""
from __future__ import annotations

import struct
import zlib

from portbench import reference

HEADER = 2  # CMF, FLG; no DICTID (FDICT is refused)
TRAILER = 4  # the Adler-32, big-endian


def check_header(blob: bytes, window_bits: int) -> None:
    """ValueError when the 2-byte header is not one that a stream at
    window_bits without a preset dictionary has (RFC 1950 2.2): CM 8,
    CINFO at most window_bits - 8, FCHECK, FDICT clear. FLEVEL is not
    judged: it is informative only."""
    if len(blob) < HEADER + TRAILER:
        raise ValueError("shorter than a zlib header and trailer")
    cmf, flg = blob[0], blob[1]
    if cmf & 0x0F != 8:
        raise ValueError("CM is not 8 (deflate)")
    if cmf >> 4 > window_bits - 8:
        raise ValueError(f"CINFO {cmf >> 4} is past windowBits {window_bits}")
    if (cmf << 8 | flg) % 31:
        raise ValueError("FCHECK: CMF*256 + FLG is not a multiple of 31")
    if flg & 0x20:
        raise ValueError("FDICT set: a preset dictionary")


def body_bytes(blob: bytes) -> int:
    return len(blob) - HEADER - TRAILER


def zero_check(blob: bytes) -> bytes:
    """The stream with its trailer's Adler-32 zeroed."""
    return blob[:-TRAILER] + bytes(TRAILER)


def fault(blob: bytes, data: bytes, window_bits: int) -> str | None:
    """Why `blob` is not a single zlib stream of `data` at window_bits
    (None when it is): the header, the deflate data read back whole, the
    trailer's Adler-32, nothing after the stream."""
    try:
        check_header(blob, window_bits)
        out, rest = reference.inflate_raw(blob[HEADER:], window_bits)
    except ValueError as e:
        return str(e)
    if len(rest) != TRAILER:
        return f"{len(rest)} bytes after the deflate data, not {TRAILER}"
    if struct.unpack(">I", rest)[0] != zlib.adler32(data):
        return "trailer Adler-32 differs from the input's"
    if out != data:
        return "decodes to other bytes than the input"
    return None
