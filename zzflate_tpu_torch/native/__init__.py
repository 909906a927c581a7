"""ctypes binding of the port's C runtime: host inflate, the anchor
pre-scan of foreign streams and of every member of a gzip buffer, the
block-header parse of the device decode's plan, the encoder's host
Huffman plan, the level 7-9 shortest-bit-path DP, the host deflate
engine and Adler-32/CRC-32.

The port's own copy of the JAX package's ``native/__init__.py``
(:72-439) plus ``scan_members``, ``parse_headers``, ``plan_lengths`` and
``plan_header``,
bound to the port's own copy of the C source, ``zzflate_native.c``
beside this file. At first use the host C compiler builds it (``-O3
-shared -fPIC``) into ``zzflate_tpu_torch/_build/`` under a name keyed on
a hash of the source and flags, so an edited source rebuilds by itself. There is no fallback:
a missing compiler or a failed build raises RuntimeError with the
compiler's output, and no wrapper returns None.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from zzflate_tpu_torch.utils.profiling import maybe_stage

_SRC = Path(__file__).resolve().parent / "zzflate_native.c"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
CC_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lib = None
_lib_lock = threading.Lock()

# zzt_inflate error codes (zzflate_native.c)
OK = 0
ERRORS = {
    -1: "invalid BTYPE",
    -2: "stored block LEN/NLEN mismatch",
    -3: "invalid Huffman table",
    -4: "invalid symbol",
    -5: "distance too far back",
    -6: "output buffer full",
    -7: "input overrun",
    -8: "need more input",
}
E_OUTFULL = -6
E_INPUT = -7
E_AGAIN = -8
# zzt_parse_headers' codes, worded as models/inflate.py's Python parse
# words them.
HEADER_ERRORS = {
    -1: "bad BTYPE",
    -3: "over-subscribed Huffman code",
    -4: "invalid Huffman code",
    -9: "repeat with no previous length",
    -10: "code length overrun",
}
# zzt_plan_header's code: a dynamic header needs more fields than a row of
# hdr_vals holds.
E_FIELDS = -11
# zzt_scan_members' codes: a member's header is malformed; its trailer is
# cut off.
E_HEADER = -12
E_TRAILER = -13
# Members a thread of the BGZF member scan takes at least. A member (at most
# 64 KiB of input) scans in ~0.22 ms on the card host's cores, so a thread
# scans for ~1.8 ms or more, against some 0.05 ms to start it and copy its
# records.
SPLIT_MIN_MEMBERS = 8
# Ranges a thread of that scan takes on average: the threads take them in
# order as each finishes its last, so one range slower than the rest holds
# up a sixteenth of a thread's share, not all of it.
SPLIT_RANGES_PER_THREAD = 16
# Bytes of deflate data a range of the byte-ranged scan of one stream takes
# at least (a thread's share): a range first looks for a block start, 0.2-2
# ms of search on the card host's cores against ~8.5 ms a MB of its scan.
SPLIT_MIN_BYTES = 1 << 20


class StreamError(ValueError):
    """Deflate data that the anchor scans find corrupt or cut short."""


def library_path() -> Path:
    """Where the built library lives: _build/, keyed on source and flags."""
    h = hashlib.sha256(" ".join(CC_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD / f"libzzflate_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the C runtime into _build/ (a no-op when the hash matches)."""
    target = library_path()
    if target.exists():
        return target
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        raise RuntimeError(
            "no host C compiler (gcc or cc): the C runtime cannot be built"
        )
    _BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        tmp_so = Path(tmp) / target.name
        r = subprocess.run(
            [cc, *CC_FLAGS, "-o", str(tmp_so), str(_SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if r.returncode != 0:
            raise RuntimeError(f"{cc} failed to build {_SRC.name}:\n{r.stdout}")
        os.replace(tmp_so, target)
    return target


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            L = ctypes.CDLL(str(build()))
            p, sz, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
            psz = ctypes.POINTER(ctypes.c_size_t)
            # in, in_len, start_bit, out, out_cap, dict_len, out_len,
            # end_bit, stop_bytes
            L.zzt_inflate.argtypes = [ctypes.c_char_p, sz, sz, p, sz, sz,
                                      psz, psz, sz]
            # the same, then bfinal_out
            L.zzt_inflate_stream.argtypes = L.zzt_inflate.argtypes + [
                ctypes.POINTER(ctypes.c_uint32)]
            # data, mlen, mdist, n, start, end, ll_bits (SB x 288),
            # d_bits (SB x 30), sub_bounds, nsb, committed, take, sel_len
            L.zzt_optimal_parse.argtypes = [
                p, p, p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                p, p, p, i, p, p, p]
            # in, n, level, strategy, dict, dict_len, max_dist, final, out,
            # out_cap, out_len
            L.zzt_deflate.argtypes = [
                ctypes.c_char_p, sz, i, i, ctypes.c_char_p, sz,
                ctypes.c_int32, i, p, sz, psz]
            # in, in_len, start_bit, T, dict_len, blocks, blocks_cap,
            # anchors, anchors_cap, nblocks, nanchors, total_out, end_bit
            L.zzt_scan_anchors.argtypes = [
                ctypes.c_char_p, sz, sz, ctypes.c_uint32, sz, p, sz, p, sz,
                psz, psz, psz, psz]
            # in, in_len, T, members, members_cap, blocks, blocks_cap,
            # anchors, anchors_cap, nmembers, nblocks, nanchors, crc
            L.zzt_scan_members.argtypes = [
                ctypes.c_char_p, sz, ctypes.c_uint32, p, sz, p, sz, p, sz,
                psz, psz, psz, ctypes.POINTER(ctypes.c_uint32)]
            # in, in_len, starts, cap, n
            L.zzt_bgzf_hop.argtypes = [ctypes.c_char_p, sz, p, sz, psz]
            # in, in_len, T, starts, nm, cuts, nranges, nthreads, then
            # as zzt_scan_members from members on
            L.zzt_scan_members_split.argtypes = [
                ctypes.c_char_p, sz, ctypes.c_uint32, p, sz, p, sz, sz,
                p, sz, p, sz, p, sz, psz, psz, psz,
                ctypes.POINTER(ctypes.c_uint32)]
            # in, in_len, start_bit, T, dict_len, cuts, ncuts, nthreads,
            # then as zzt_scan_anchors from blocks on, and taken
            L.zzt_scan_stream_split.argtypes = [
                ctypes.c_char_p, sz, sz, ctypes.c_uint32, sz, p, sz, sz,
                p, sz, p, sz, psz, psz, psz, psz, psz]
            # in, in_len, T, cuts, ncuts, nthreads, then as
            # zzt_scan_members from members on, and taken
            L.zzt_scan_gzip_split.argtypes = [
                ctypes.c_char_p, sz, ctypes.c_uint32, p, sz, sz,
                p, sz, p, sz, p, sz, psz, psz, psz,
                ctypes.POINTER(ctypes.c_uint32), psz]
            # in, in_len, bit, lim
            L.zzt_find_block.argtypes = [ctypes.c_char_p, sz, sz, sz]
            L.zzt_find_block.restype = sz
            # in, in_len, start_bits, end_bytes, nb, hdr_end, desc, ll_sym,
            # d_sym, failed
            L.zzt_parse_headers.argtypes = [
                ctypes.c_char_p, sz, p, p, sz, p, p, p, p, psz]
            # ng, freq_ll, freq_d, ll_len, d_len, body
            L.zzt_plan_lengths.argtypes = [sz, p, p, p, p, p]
            # ng, ll_dyn, d_dyn, body, bfinal, bounds, slots, ll_len,
            # ll_code, d_len, d_code, hdr_vals, hdr_nbits, eob_v, eob_nb,
            # nfields
            L.zzt_plan_header.argtypes = [sz, p, p, p, p, p, sz, p, p, p, p,
                                          p, p, p, p, psz]
            for fn in (L.zzt_inflate, L.zzt_inflate_stream,
                       L.zzt_optimal_parse, L.zzt_deflate,
                       L.zzt_scan_anchors, L.zzt_scan_members,
                       L.zzt_bgzf_hop, L.zzt_scan_members_split,
                       L.zzt_scan_stream_split, L.zzt_scan_gzip_split,
                       L.zzt_parse_headers,
                       L.zzt_plan_lengths, L.zzt_plan_header):
                fn.restype = ctypes.c_int
            # value, buf, len
            for fn in (L.zzt_adler32, L.zzt_crc32):
                fn.argtypes = [ctypes.c_uint32, ctypes.c_char_p, sz]
                fn.restype = ctypes.c_uint32
            _lib = L
    return _lib


def adler32(data, value: int = 1) -> int:
    """Adler-32 of `data` continued from `value` (zlib.adler32's
    contract; any buffer), computed by the C runtime."""
    if not isinstance(data, bytes):
        data = bytes(data)  # c_char_p takes bytes only
    return int(lib().zzt_adler32(value, data, len(data)))


def crc32(data, value: int = 0) -> int:
    """CRC-32 of `data` continued from `value` (zlib.crc32's contract;
    any buffer), computed by the C runtime (slice-by-8)."""
    if not isinstance(data, bytes):
        data = bytes(data)
    return int(lib().zzt_crc32(value, data, len(data)))


def inflate_raw(
    data: bytes,
    dictionary: bytes = b"",
    bitpos: int = 0,
    out_cap_hint: int | None = None,
) -> tuple[bytes, int]:
    """Raw-deflate decode. Returns (output, end_bitpos).

    Raises ValueError on malformed streams (the contract of the Python
    decoder in models/inflate.py). Grows the output buffer geometrically
    when it fills."""
    L = lib()
    dictionary = dictionary[-32768:]
    dlen = len(dictionary)
    cap = out_cap_hint or max(4 * len(data) + 4096, 1 << 16)
    while True:
        buf = ctypes.create_string_buffer(dlen + cap)
        if dlen:
            ctypes.memmove(buf, dictionary, dlen)
        out_len = ctypes.c_size_t(0)
        end_bit = ctypes.c_size_t(0)
        rc = L.zzt_inflate(
            data, len(data), bitpos, ctypes.byref(buf), dlen + cap, dlen,
            ctypes.byref(out_len), ctypes.byref(end_bit), 0,
        )
        if rc == OK:
            out = ctypes.string_at(ctypes.addressof(buf) + dlen, out_len.value)
            return out, end_bit.value
        if rc == E_OUTFULL:
            cap *= 4
            continue
        raise ValueError(ERRORS.get(rc, f"inflate error {rc}"))


def inflate_stream(
    data: bytes,
    window: bytes = b"",
    bitpos: int = 0,
    stop_bytes: int = 0,
    out_cap_hint: int | None = None,
) -> tuple[bytes, int, bool, bool]:
    """Incremental raw-deflate decode of as many complete blocks as `data`
    allows, starting at `bitpos` with `window` as back-reference context.

    Returns (output, end_bitpos, bfinal_reached, need_more_input). When
    need_more_input is True, end_bitpos is the last complete block
    boundary; feed more bytes and call again from there. Raises
    ValueError on corruption strictly inside the available input."""
    L = lib()
    window = window[-32768:]
    dlen = len(window)
    cap = out_cap_hint or max(4 * len(data) + 4096, 1 << 16)
    while True:
        buf = ctypes.create_string_buffer(dlen + cap)
        if dlen:
            ctypes.memmove(buf, window, dlen)
        out_len = ctypes.c_size_t(0)
        end_bit = ctypes.c_size_t(0)
        bfinal = ctypes.c_uint32(0)
        rc = L.zzt_inflate_stream(
            data, len(data), bitpos, ctypes.byref(buf), dlen + cap, dlen,
            ctypes.byref(out_len), ctypes.byref(end_bit), stop_bytes,
            ctypes.byref(bfinal),
        )
        if rc == E_OUTFULL:
            cap *= 4
            continue
        if rc in (OK, E_AGAIN):
            out = ctypes.string_at(ctypes.addressof(buf) + dlen, out_len.value)
            return out, end_bit.value, bool(bfinal.value), rc == E_AGAIN
        raise ValueError(ERRORS.get(rc, f"inflate error {rc}"))


def scan_anchors(data: bytes, anchor_tokens: int, bitpos: int = 0,
                 dict_len: int = 0, threads: int | None = None):
    """Anchor pre-scan of a raw deflate stream (no output materialized).

    Returns (blocks, anchors, total_out, end_bit):
      blocks  -- int64 (nb, 5): [start_bit, btype, out_start,
                 stored_payload_byte_off, stored_len]
      anchors -- int64 (na, 2): [bit, out] of every anchor_tokens-th
                 token within its block (bit BEFORE the token's code)
    These are the lane records the device anchor walk consumes
    (models/inflate_device.py), so a foreign (unindexed) stream decodes
    on the card after this host scan. Raises StreamError on corruption.

    A stream of SPLIT_MIN_BYTES a thread or more scans in byte ranges at
    once, on as many threads as the host's cores (`threads` sets the
    count; 1 is the serial pass), in a span decode_scan_stream_split.
    The answer is the serial pass's; where the ranged scan fails (a
    corrupt stream), the serial pass runs and gives the verdict."""
    data = bytes(data)
    n = len(data)
    threads = _split_threads(n - bitpos // 8, threads)
    if threads >= 2:
        with maybe_stage("decode_scan_stream_split"):
            got = _scan_stream_ranges(
                data, anchor_tokens, _cuts(bitpos // 8, n, threads), threads,
                bitpos, dict_len)
        if got is not None:
            return got[:4]
    L = lib()
    nb, na, total_out, end_bit = (ctypes.c_size_t(0) for _ in range(4))

    def scan(blocks, anchors):
        rc = L.zzt_scan_anchors(
            data, n, bitpos, anchor_tokens, dict_len,
            blocks.ctypes.data, len(blocks), anchors.ctypes.data,
            len(anchors), ctypes.byref(nb), ctypes.byref(na),
            ctypes.byref(total_out), ctypes.byref(end_bit))
        return rc, (nb.value, na.value)

    rc, (blocks, anchors) = _scan_grown(
        scan, _scan_caps(n, anchor_tokens, 0), (5, 2))
    if rc != OK:
        raise StreamError(ERRORS.get(rc, f"inflate error {rc}"))
    return blocks, anchors, total_out.value, end_bit.value


def scan_members(data: bytes, anchor_tokens: int,
                 threads: int | None = None):
    """scan_anchors over every member of a gzip buffer, in one C pass.

    Members follow one another while the two bytes after a trailer are
    the gzip magic; bytes after the last member are left alone. Returns
    (members, blocks, anchors, crc), every bit and byte from the buffer's
    start and every output offset in the members' concatenated output:
      members -- int64 (nm, 7): header and body start bytes, the bit
                 after the final block, output start and bytes, and the
                 trailer's CRC-32 and ISIZE
      blocks  -- int64 (nb, 6): scan_anchors' five columns and the member
      anchors -- int64 (na, 3): [bit, out] and the index of the block
      crc     -- the CRC-32 of the whole output that the trailers state
                 (their CRC-32s combined over the scanned lengths)
    Each member's window starts empty. Raises ValueError on a malformed
    header or a cut trailer, StreamError on corrupt deflate data.

    When every member states its length (BGZF, bgzf_starts), contiguous
    ranges of members scan at once on threads, as many as the host's
    cores with SPLIT_MIN_MEMBERS members a thread or more, in a span
    decode_scan_split. Any other buffer of SPLIT_MIN_BYTES a thread or
    more scans in byte ranges of its members' blocks, as one stream does
    in scan_anchors, in a span decode_scan_stream_split. `threads` sets
    the count (1 is the serial pass). The answer is the serial pass's;
    where a range fails or its members do not end where the hop says, the
    serial pass runs and decides."""
    data = bytes(data)
    starts = bgzf_starts(data) if threads != 1 else None
    if starts is not None:
        nm = len(starts) - 1
        if threads is None:
            threads = min(len(os.sched_getaffinity(0)),
                          nm // SPLIT_MIN_MEMBERS)
        threads = min(threads, nm)
        if threads >= 2:
            with maybe_stage("decode_scan_split"):
                got = _scan_ranges(data, anchor_tokens, starts, threads)
            if got is not None:
                return got
    elif threads != 1:
        threads = _split_threads(len(data), threads)
        if threads >= 2:
            with maybe_stage("decode_scan_stream_split"):
                got = _scan_gzip_ranges(data, anchor_tokens,
                                        _cuts(0, len(data), threads), threads)
            if got is not None:
                return got[:4]
    return _scan_serial(data, anchor_tokens)


def bgzf_starts(data: bytes) -> np.ndarray | None:
    """int64 (nm + 1,): each member's start and the end of the last, from
    a hop through BGZF headers (each FEXTRA's BC subfield states BSIZE,
    the member's length - 1); None unless every member found has one."""
    n = len(data)
    starts = np.empty(n // 26 + 3, np.int64)  # 26 B a member at least
    nm = ctypes.c_size_t(0)
    rc = lib().zzt_bgzf_hop(data, n, starts.ctypes.data, len(starts),
                            ctypes.byref(nm))
    return starts[: nm.value + 1] if rc == OK else None


def _scan_caps(n: int, anchor_tokens: int, nm: int) -> tuple[int, int]:
    """First guesses of the block and anchor caps, with room for a block
    a member (at least nm members)."""
    return (max(64, n // 8192) + nm,
            max(64, (8 * n) // max(1, anchor_tokens)))


def _scan_grown(scan, caps, cols):
    """scan(*arrays) on zeroed int64 arrays of caps[i] rows and cols[i]
    columns, again on larger ones while a cap is too small (E_OUTFULL:
    the counts scan returns hold the sizes). Returns its code and the
    arrays cut to its counts."""
    while True:
        arrays = [np.zeros((c, k), np.int64) for c, k in zip(caps, cols)]
        rc, counts = scan(*arrays)
        if rc != E_OUTFULL:
            return rc, [a[:m] for a, m in zip(arrays, counts)]
        caps = [max(c, m + 1) for c, m in zip(caps, counts)]


def _split_threads(body: int, threads: int | None) -> int:
    """Threads of a byte-ranged scan of `body` bytes: as many as the host's
    cores with SPLIT_MIN_BYTES a range, or `threads`; at most one a
    byte."""
    if threads is None:
        threads = min(len(os.sched_getaffinity(0)), body // SPLIT_MIN_BYTES)
    return min(threads, body)


def _cuts(lo: int, hi: int, k: int) -> np.ndarray:
    """The k - 1 bytes that cut [lo, hi) into k ranges of about equal
    bytes (hi - lo >= k)."""
    return lo + (hi - lo) * np.arange(1, k, dtype=np.int64) // k


def _scan_stream_ranges(data: bytes, anchor_tokens: int, cuts, threads: int,
                        bitpos: int = 0, dict_len: int = 0):
    """zzt_scan_stream_split: scan_anchors' answer and the count of ranges
    whose records it took, the stream cut into ranges at the bytes `cuts`
    (rising strictly inside (bitpos // 8, len(data))) and scanned on
    `threads` threads; None where the ranged scan fails (a corrupt stream,
    cuts out of order)."""
    L = lib()
    n = len(data)
    cuts = np.ascontiguousarray(cuts, np.int64)
    nb, na, total_out, end_bit, taken = (
        ctypes.c_size_t(0) for _ in range(5))

    def scan(blocks, anchors):
        rc = L.zzt_scan_stream_split(
            data, n, bitpos, anchor_tokens, dict_len, cuts.ctypes.data,
            len(cuts), threads, blocks.ctypes.data, len(blocks),
            anchors.ctypes.data, len(anchors), ctypes.byref(nb),
            ctypes.byref(na), ctypes.byref(total_out), ctypes.byref(end_bit),
            ctypes.byref(taken))
        return rc, (nb.value, na.value)

    rc, (blocks, anchors) = _scan_grown(
        scan, _scan_caps(n, anchor_tokens, 0), (5, 2))
    if rc != OK:
        return None
    return blocks, anchors, total_out.value, end_bit.value, taken.value


def _scan_gzip_ranges(data: bytes, anchor_tokens: int, cuts, threads: int):
    """zzt_scan_gzip_split: scan_members' answer and the count of ranges
    taken, the buffer cut into ranges of its members' blocks at the bytes
    `cuts` (rising strictly inside (0, len(data))) and scanned on
    `threads` threads; None where the ranged scan fails."""
    L = lib()
    n = len(data)
    cuts = np.ascontiguousarray(cuts, np.int64)
    nm, nb, na, taken = (ctypes.c_size_t(0) for _ in range(4))
    crc = ctypes.c_uint32(0)

    def scan(members, blocks, anchors):
        rc = L.zzt_scan_gzip_split(
            data, n, anchor_tokens, cuts.ctypes.data, len(cuts), threads,
            members.ctypes.data, len(members), blocks.ctypes.data,
            len(blocks), anchors.ctypes.data, len(anchors),
            ctypes.byref(nm), ctypes.byref(nb), ctypes.byref(na),
            ctypes.byref(crc), ctypes.byref(taken))
        return rc, (nm.value, nb.value, na.value)

    mcap = max(16, n // 16384)
    rc, got = _scan_grown(scan, (mcap, *_scan_caps(n, anchor_tokens, mcap)),
                          (7, 6, 3))
    return (*got, crc.value, taken.value) if rc == OK else None


def _find_block(data: bytes, bit: int, lim: int) -> int | None:
    """The first bit in [bit, lim) where the ranged scan's finder lets a
    range begin (zzflate_native.c find_block), or None."""
    got = lib().zzt_find_block(data, len(data), bit, lim)
    return None if got == ctypes.c_size_t(-1).value else got


def _scan_ranges(data: bytes, anchor_tokens: int, starts: np.ndarray,
                 threads: int):
    """zzt_scan_members_split on `threads` threads, over ranges of about
    equal bytes, SPLIT_RANGES_PER_THREAD a thread or one a member; None
    where the ranges disagree with the hop."""
    L = lib()
    n = len(data)
    nm = len(starts) - 1
    k = min(nm, threads * SPLIT_RANGES_PER_THREAD)
    cuts = np.searchsorted(starts, starts[-1] * np.arange(1, k) / k)
    cuts = np.unique(np.r_[0, np.clip(cuts, 1, nm - 1), nm]).astype(np.int64)
    nmc, nb, na = (ctypes.c_size_t(0) for _ in range(3))
    crc = ctypes.c_uint32(0)

    def scan(members, blocks, anchors):
        rc = L.zzt_scan_members_split(
            data, n, anchor_tokens, starts.ctypes.data, nm, cuts.ctypes.data,
            len(cuts) - 1, threads, members.ctypes.data, len(members),
            blocks.ctypes.data, len(blocks), anchors.ctypes.data,
            len(anchors), ctypes.byref(nmc), ctypes.byref(nb),
            ctypes.byref(na), ctypes.byref(crc))
        return rc, (nmc.value, nb.value, na.value)

    rc, got = _scan_grown(scan, (nm, *_scan_caps(n, anchor_tokens, nm)),
                          (7, 6, 3))
    return (*got, crc.value) if rc == OK else None


def _scan_serial(data: bytes, anchor_tokens: int):
    """zzt_scan_members: the one pass over every member."""
    L = lib()
    n = len(data)
    nm, nb, na = (ctypes.c_size_t(0) for _ in range(3))
    crc = ctypes.c_uint32(0)

    def scan(members, blocks, anchors):
        rc = L.zzt_scan_members(
            data, n, anchor_tokens, members.ctypes.data, len(members),
            blocks.ctypes.data, len(blocks), anchors.ctypes.data,
            len(anchors), ctypes.byref(nm), ctypes.byref(nb),
            ctypes.byref(na), ctypes.byref(crc))
        return rc, (nm.value, nb.value, na.value)

    mcap = max(16, n // 16384)  # BGZF's 64 KiB members
    rc, got = _scan_grown(scan, (mcap, *_scan_caps(n, anchor_tokens, mcap)),
                          (7, 6, 3))
    if rc == OK:
        return (*got, crc.value)
    if rc == E_HEADER:
        raise ValueError(f"gzip member {nm.value}: bad header")
    if rc == E_TRAILER:
        raise ValueError("truncated gzip member")
    raise StreamError(ERRORS.get(rc, f"inflate error {rc}"))


def parse_headers(body: bytes, start_bits, end_bytes):
    """Block headers of a raw deflate body, in one call for all blocks.

    start_bits: (nb,) each block's first bit (its BFINAL bit); end_bytes:
    (nb,) or one int, the byte where each block's segment ends (clamped
    to the body). Returns (hdr_end, ll, d): hdr_end (nb,) int64, the bit
    of each block's first token; ll and d, each (first, cnt, off, sym),
    the canonical descriptors that models/inflate_device._canon_desc
    builds, as (nb, 16) int32 arrays and a (nb, 288) or (nb, 32) sym.
    Accepts and rejects what models/inflate.py's _read_dynamic_tables
    and CanonicalDecoder do, at the first bad block: ValueError with the
    Python parse's words, IndexError where its BitReader would read past
    the segment's end."""
    L = lib()
    if not isinstance(body, bytes):
        body = bytes(body)  # c_char_p takes bytes only
    starts = np.ascontiguousarray(start_bits, np.int64)
    nb = len(starts)
    ends = np.ascontiguousarray(np.broadcast_to(end_bytes, (nb,)), np.int64)
    hdr_end = np.empty(nb, np.int64)
    desc = np.empty((6, nb, 16), np.int32)
    ll_sym = np.empty((nb, 288), np.int32)
    d_sym = np.empty((nb, 32), np.int32)
    failed = ctypes.c_size_t(0)
    rc = L.zzt_parse_headers(
        body, len(body), starts.ctypes.data, ends.ctypes.data, nb,
        hdr_end.ctypes.data, desc.ctypes.data, ll_sym.ctypes.data,
        d_sym.ctypes.data, ctypes.byref(failed),
    )
    if rc == E_INPUT:
        raise IndexError(f"block {failed.value}: header runs past its "
                         "segment")
    if rc != OK:
        raise ValueError(HEADER_ERRORS.get(rc, f"header error {rc}"))
    return hdr_end, (*desc[:3], ll_sym), (*desc[3:], d_sym)


def plan_lengths(freq_ll, freq_d):
    """The dynamic code lengths of ng block groups in one call: the
    forcing rules of the reference's ``ops/huffman_host.build_tables`` and
    its two ``code_lengths`` at 15 bits. freq_ll (ng, 288), freq_d (ng,
    30): each group's summed histograms, EOB not yet counted. Returns
    (ll_len (ng, 288) int32, d_len (ng, 30) int32, body (ng, 2) int64: the
    body's bits under the fixed and under the dynamic codes)."""
    freq_ll = np.ascontiguousarray(freq_ll, np.int64)
    freq_d = np.ascontiguousarray(freq_d, np.int64)
    ng = len(freq_ll)
    if freq_ll.shape != (ng, 288) or freq_d.shape != (ng, 30):
        raise ValueError("plan_lengths: array shapes do not agree")
    ll_len = np.empty((ng, 288), np.int32)
    d_len = np.empty((ng, 30), np.int32)
    body = np.empty((ng, 2), np.int64)
    lib().zzt_plan_lengths(ng, freq_ll.ctypes.data, freq_d.ctypes.data,
                           ll_len.ctypes.data, d_len.ctypes.data,
                           body.ctypes.data)
    return ll_len, d_len, body


def plan_header(lengths, bfinal, bounds, slots: int) -> dict:
    """The tables of ng block groups in one call, as
    ``ops/huffman_host.build_batch_plans`` lays them out: group g covers
    rows [bounds[g], bounds[g + 1]) of the batch's sub-blocks. lengths:
    plan_lengths' result, or None for the fixed codes in every group;
    bfinal (ng,): each group's BFINAL bit. Returns the (R, ...) arrays
    ll_len/ll_code (R, 288), d_len/d_code (R, 30), hdr_vals/hdr_nbits (R,
    slots), eob_v/eob_nb (R,): the chosen lengths and codes on every row,
    the header on a group's first row, its EOB on its last. Raises
    ValueError when a dynamic header needs more than `slots` fields."""
    bounds = np.ascontiguousarray(bounds, np.int64)
    bfinal = np.ascontiguousarray(bfinal, np.int64)
    ng = len(bounds) - 1
    rows = int(bounds[-1])
    if bfinal.shape != (ng,):
        raise ValueError("plan_header: array shapes do not agree")
    if lengths is None:
        ll_dyn = d_dyn = body = None
    else:
        ll_dyn, d_dyn, body = (np.ascontiguousarray(a) for a in lengths)
        if (ll_dyn.shape != (ng, 288) or d_dyn.shape != (ng, 30)
                or body.shape != (ng, 2)):
            raise ValueError("plan_header: array shapes do not agree")
    out = {
        "ll_len": np.zeros((rows, 288), np.int32),
        "ll_code": np.zeros((rows, 288), np.uint32),
        "d_len": np.zeros((rows, 30), np.int32),
        "d_code": np.zeros((rows, 30), np.uint32),
        "hdr_vals": np.zeros((rows, slots), np.uint32),
        "hdr_nbits": np.zeros((rows, slots), np.int32),
        "eob_v": np.zeros((rows,), np.uint32),
        "eob_nb": np.zeros((rows,), np.int32),
    }
    nfields = ctypes.c_size_t(0)
    rc = lib().zzt_plan_header(
        ng, *(None if a is None else a.ctypes.data
              for a in (ll_dyn, d_dyn, body)),
        bfinal.ctypes.data, bounds.ctypes.data, slots,
        *(a.ctypes.data for a in out.values()), ctypes.byref(nfields),
    )
    if rc == E_FIELDS:
        raise ValueError(f"dynamic header needs {nfields.value} fields")
    if rc != OK:
        raise RuntimeError(f"zzt_plan_header failed: {rc}")
    return out


def optimal_parse(data, mlen, mdist, start, end, ll_bits, d_bits, bounds):
    """Shortest-bit-path parse of one chunk (levels 7-9).

    data/mlen/mdist: (N,) uint8/int32/int32; ll_bits (SB, 288) and d_bits
    (SB, 30) int32 code lengths pricing each sub-block (a zero length is
    priced at 30 bits); bounds: the SB+1 sub-block boundaries. Positions
    [start, end) are parsed. Returns (committed, take, sel_len) numpy
    arrays of length N."""
    L = lib()
    n = len(data)
    data = np.ascontiguousarray(data, np.uint8)
    mlen = np.ascontiguousarray(mlen, np.int32)
    mdist = np.ascontiguousarray(mdist, np.int32)
    ll_bits = np.ascontiguousarray(ll_bits, np.int32)
    d_bits = np.ascontiguousarray(d_bits, np.int32)
    sub_bounds = np.ascontiguousarray(bounds, np.int64)
    nsb = ll_bits.shape[0]
    if (mlen.shape != (n,) or mdist.shape != (n,)
            or ll_bits.shape != (nsb, 288) or d_bits.shape != (nsb, 30)
            or sub_bounds.shape != (nsb + 1,)):
        raise ValueError("optimal_parse: array shapes do not agree")
    committed = np.zeros(n, np.uint8)
    take = np.zeros(n, np.uint8)
    sel_len = np.zeros(n, np.int32)
    rc = L.zzt_optimal_parse(
        data.ctypes.data, mlen.ctypes.data, mdist.ctypes.data,
        n, int(start), int(end),
        ll_bits.ctypes.data, d_bits.ctypes.data, sub_bounds.ctypes.data, nsb,
        committed.ctypes.data, take.ctypes.data, sel_len.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"zzt_optimal_parse failed: {rc}")
    return committed.astype(bool), take.astype(bool), sel_len


def deflate_raw(
    data: bytes,
    level: int = 6,
    dictionary: bytes = b"",
    max_dist: int = 32768,
    final: bool = True,
    strategy: int = 0,
) -> bytes:
    """One-shot raw-deflate encode on the host (zzt_deflate): a hash-chain
    matcher with zlib's good/lazy/nice/chain effort table and a per-64 KiB
    stored/fixed/dynamic choice. final=False closes with a sync-flush
    empty stored block, so segments concatenate into one valid stream."""
    L = lib()
    dictionary = dictionary[-32768:]
    n = len(data)
    # Stored-fallback bound + per-64 KiB block headers + slack.
    cap = n + 5 * (n // 65535 + 2) + (n // 65536 + 2) * 320 + 1024
    buf = ctypes.create_string_buffer(cap)
    out_len = ctypes.c_size_t(0)
    rc = L.zzt_deflate(
        data, n, int(level), int(strategy), dictionary, len(dictionary),
        int(max_dist), 1 if final else 0,
        ctypes.byref(buf), cap, ctypes.byref(out_len),
    )
    if rc != 0:
        raise RuntimeError(f"zzt_deflate failed: {rc}")
    return ctypes.string_at(ctypes.addressof(buf), out_len.value)


def deflate_raw_mt(
    data: bytes,
    level: int = 6,
    dictionary: bytes = b"",
    max_dist: int = 32768,
    final: bool = True,
    strategy: int = 0,
    chunk_bytes: int = 1 << 20,
    threads: int | None = None,
) -> bytes:
    """Chunk-parallel host encode: chunks of chunk_bytes, each seeded with
    the previous 32 KiB as its dictionary, encoded on a thread pool
    (zzt_deflate releases the GIL) and joined with sync-flush framing into
    one valid deflate stream.

    The chunk layout, and so the output, depends only on the data and
    the parameters: `threads` changes wall time, never bytes."""
    n = len(data)
    if n <= chunk_bytes:
        return deflate_raw(
            data, level=level, dictionary=dictionary, max_dist=max_dist,
            final=final, strategy=strategy,
        )
    nchunks = -(-n // chunk_bytes)

    def one(i: int) -> bytes:
        lo = i * chunk_bytes
        hi = min(n, lo + chunk_bytes)
        dic = dictionary if i == 0 else data[max(0, lo - 32768) : lo]
        return deflate_raw(
            data[lo:hi], level=level, dictionary=dic, max_dist=max_dist,
            final=final and i == nchunks - 1, strategy=strategy,
        )

    nth = threads or min(8, os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(max_workers=nth) as pool:
        return b"".join(pool.map(one, range(nchunks)))
