"""Inflate: the host decoder.

The port's own copy of ``zzflate_tpu/models/inflate.py``. The plain
Python decoder (``BitReader``, ``CanonicalDecoder``, ``inflate_raw``,
``inflate_blocks``: LSB-first bit reader, canonical table decode, block
walker, overlapping LZ copy) is the oracle of the tests and what an
incremental decoder builds on. ``decompress`` parses the container,
decodes with the port's C runtime (never the Python decoder) and
verifies the stdlib Adler-32 or CRC-32.
"""
from __future__ import annotations

import struct
import zlib as _zlib

from zzflate_tpu_torch import constants as C
from zzflate_tpu_torch import native
from zzflate_tpu_torch.utils import containers


class BitReader:
    __slots__ = ("data", "bitpos")

    def __init__(self, data: bytes, bitpos: int = 0):
        self.data = data
        self.bitpos = bitpos

    def bits(self, n: int) -> int:
        """Read n bits LSB-first."""
        out = 0
        for i in range(n):
            byte = self.data[self.bitpos >> 3]
            out |= ((byte >> (self.bitpos & 7)) & 1) << i
            self.bitpos += 1
        return out

    def align(self) -> None:
        self.bitpos = (self.bitpos + 7) & ~7


class CanonicalDecoder:
    """Canonical Huffman decoder: first_code/offset per length."""

    __slots__ = ("counts", "first_code", "offsets", "syms", "max_len")

    def __init__(self, lengths):
        max_len = max(lengths) if lengths else 0
        counts = [0] * (max_len + 1)
        for ln in lengths:
            if ln:
                counts[ln] += 1
        first_code = [0] * (max_len + 2)
        offsets = [0] * (max_len + 2)
        code = 0
        offset = 0
        for ln in range(1, max_len + 1):
            first_code[ln] = code
            offsets[ln] = offset
            code = (code + counts[ln]) << 1
            offset += counts[ln]
        # Over-subscription check (Kraft): code after processing length L
        # must not exceed 2^L.
        code = 0
        for ln in range(1, max_len + 1):
            code = (code + counts[ln]) << 1
            if code > (1 << (ln + 1)):
                raise ValueError("over-subscribed Huffman code")
        syms = sorted(
            (s for s in range(len(lengths)) if lengths[s]),
            key=lambda s: (lengths[s], s),
        )
        self.counts = counts
        self.first_code = first_code
        self.offsets = offsets
        self.syms = syms
        self.max_len = max_len

    def decode(self, br: BitReader) -> int:
        code = 0
        for ln in range(1, self.max_len + 1):
            code = (code << 1) | br.bits(1)
            if self.counts[ln] and code - self.first_code[ln] < self.counts[ln]:
                return self.syms[self.offsets[ln] + code - self.first_code[ln]]
        raise ValueError("invalid Huffman code")


_FIXED_LL = CanonicalDecoder(list(C.fixed_litlen_lengths()))
_FIXED_D = CanonicalDecoder(list(C.fixed_dist_lengths()))


def _read_dynamic_tables(br: BitReader) -> tuple[CanonicalDecoder, CanonicalDecoder]:
    hlit = br.bits(5) + 257
    hdist = br.bits(5) + 1
    hclen = br.bits(4) + 4
    cl_lengths = [0] * 19
    for i in range(hclen):
        cl_lengths[int(C.CL_ORDER[i])] = br.bits(3)
    cl_dec = CanonicalDecoder(cl_lengths)
    lengths: list[int] = []
    while len(lengths) < hlit + hdist:
        sym = cl_dec.decode(br)
        if sym < 16:
            lengths.append(sym)
        elif sym == 16:
            if not lengths:
                raise ValueError("repeat with no previous length")
            lengths += [lengths[-1]] * (3 + br.bits(2))
        elif sym == 17:
            lengths += [0] * (3 + br.bits(3))
        else:
            lengths += [0] * (11 + br.bits(7))
    if len(lengths) != hlit + hdist:
        raise ValueError("code length overrun")
    ll = lengths[:hlit]
    dd = lengths[hlit:]
    # Single-distance-code blocks may legally be "incomplete".
    return CanonicalDecoder(ll), CanonicalDecoder(dd)


def _decode_block(br: BitReader, out: bytearray, data: bytes) -> int:
    """Decode ONE deflate block into `out`. Returns the BFINAL bit.

    Raises IndexError/struct.error on input exhaustion (retryable with
    more input) and ValueError on definitive corruption."""
    bfinal = br.bits(1)
    btype = br.bits(2)
    if btype == 0:
        br.align()
        bytepos = br.bitpos >> 3
        ln, nlen = struct.unpack("<HH", data[bytepos : bytepos + 4])
        if ln != (nlen ^ 0xFFFF):
            raise ValueError("stored block LEN/NLEN mismatch")
        if bytepos + 4 + ln > len(data):
            raise IndexError("stored block payload truncated")
        out += data[bytepos + 4 : bytepos + 4 + ln]
        br.bitpos = (bytepos + 4 + ln) << 3
    elif btype in (1, 2):
        if btype == 1:
            ll_dec, d_dec = _FIXED_LL, _FIXED_D
        else:
            ll_dec, d_dec = _read_dynamic_tables(br)
        while True:
            sym = ll_dec.decode(br)
            if sym < 256:
                out.append(sym)
            elif sym == 256:
                break
            else:
                lc = sym - 257
                if lc >= 29:
                    raise ValueError("invalid length symbol")
                length = int(C.LENGTH_BASE[lc]) + br.bits(int(C.LENGTH_EXTRA[lc]))
                dsym = d_dec.decode(br)
                if dsym >= 30:
                    raise ValueError("invalid distance symbol")
                dist = int(C.DIST_BASE[dsym]) + br.bits(int(C.DIST_EXTRA[dsym]))
                if dist > len(out):
                    raise ValueError("distance too far back")
                # Overlapping copy, byte at a time semantics.
                start = len(out) - dist
                if dist >= length:
                    out += out[start : start + length]
                else:
                    for i in range(length):
                        out.append(out[start + i])
    else:
        raise ValueError("invalid BTYPE 3")
    return bfinal


def inflate_raw(
    data: bytes,
    dictionary: bytes = b"",
    bitpos: int = 0,
    stop_after_bytes: int | None = None,
) -> tuple[bytes, int]:
    """Decode a raw deflate stream. Returns (output, end_bitpos)."""
    br = BitReader(data, bitpos)
    out = bytearray(dictionary[-C.WINDOW_SIZE :])
    dict_len = len(out)
    while True:
        if _decode_block(br, out, data):
            break
        if stop_after_bytes is not None and len(out) - dict_len >= stop_after_bytes:
            break
    return bytes(out[dict_len:]), br.bitpos


def inflate_blocks(
    data: bytes,
    window: bytes = b"",
    bitpos: int = 0,
    stop_bytes: int = 0,
) -> tuple[bytes, int, bool, bool]:
    """Incremental decode of as many COMPLETE blocks as `data` allows.

    Pure-Python analogue of native.inflate_stream (same contract):
    returns (output, end_bitpos, bfinal_reached, need_more_input); on
    need_more_input, end_bitpos is the last complete block boundary.
    ValueError = definitive corruption (the Python bit reader raises
    IndexError, not garbage decode, on exhaustion, so any ValueError is
    backed by real input bytes)."""
    br = BitReader(data, bitpos)
    out = bytearray(window[-C.WINDOW_SIZE :])
    dict_len = len(out)
    chk_bit, chk_w = bitpos, dict_len
    bfinal = False
    try:
        while True:
            chk_bit, chk_w = br.bitpos, len(out)
            if _decode_block(br, out, data):
                bfinal = True
                break
            if stop_bytes and len(out) - dict_len >= stop_bytes:
                break
    except (IndexError, struct.error):
        return bytes(out[dict_len:chk_w]), chk_bit, False, True
    return bytes(out[dict_len:]), br.bitpos, bfinal, False


def decompress(
    data: bytes, format: str = "zlib", dictionary: bytes | None = None
) -> bytes:
    """Decode a zlib/gzip/raw stream with the C decoder, verifying
    checksums; ValueError on a bad or truncated stream."""
    if format == "zlib":
        hdr_len, dictid = containers.parse_zlib_header(data)
        if dictid is not None:
            if dictionary is None:
                raise ValueError("stream requires a preset dictionary")
            if _zlib.adler32(dictionary) != dictid:
                raise ValueError("dictionary id mismatch")
        out, endbit = native.inflate_raw(data, dictionary or b"", hdr_len * 8)
        endbyte = (endbit + 7) >> 3
        if endbyte + 4 > len(data):
            raise ValueError("truncated zlib trailer")
        (adler,) = struct.unpack(">I", data[endbyte : endbyte + 4])
        if _zlib.adler32(out) != adler:
            raise ValueError("adler32 mismatch")
        return out
    if format == "gzip":
        # Multi-member streams (RFC 1952 section 2.2: members simply
        # concatenate) decode to the concatenation of their contents.
        parts = []
        pos = 0
        while pos < len(data):
            member = data[pos:]
            hdr_len = containers.parse_gzip_header(member)
            out, endbit = native.inflate_raw(member, b"", hdr_len * 8)
            endbyte = (endbit + 7) >> 3
            if endbyte + 8 > len(member):
                raise ValueError("truncated gzip trailer")
            crc, isize = struct.unpack(
                "<II", member[endbyte : endbyte + 8]
            )
            if _zlib.crc32(out) != crc:
                raise ValueError("crc32 mismatch")
            if (len(out) & 0xFFFFFFFF) != isize:
                raise ValueError("isize mismatch")
            parts.append(out)
            pos += endbyte + 8
            if pos < len(data) and data[pos : pos + 2] != b"\x1f\x8b":
                break  # trailing garbage is tolerated (gzip(1) behavior)
        return b"".join(parts)
    if format == "raw":
        out, _ = native.inflate_raw(data, dictionary or b"", 0)
        return out
    raise ValueError(f"unknown format {format!r}")
