"""The byte-ranged anchor scan of one deflate stream
(``native.scan_anchors`` and ``native.scan_members`` with threads > 1:
``zzt_scan_stream_split``, ``zzt_scan_gzip_split``) held to the serial pass
(threads=1) on every array, count and CRC-32: zlib, gzip and raw streams at
levels 1, 6 and 9, streams that mix stored, fixed and dynamic blocks, a
final block before the last cut, two large members with trailing bytes,
cuts placed inside stored blocks, one byte before a block start and on a
planted block that is not one, and the serial pass's verdicts on corrupt
streams. The finder (``native._find_block``) is held to the block starts
the serial pass records."""
import gzip
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from zzflate_tpu_torch import native
from zzflate_tpu_torch.models import inflate_device as idv
from zzflate_tpu_torch.utils import profiling
from zzflate_tpu_torch.utils.corpus import mixed_corpus

# One thread apiece: the test processes share the CPU.
torch.set_num_threads(1)

T = 64  # inflate_device.FOREIGN_ANCHOR_TOKENS
DATA = mixed_corpus(600000, 27)  # zlib writes some 10 blocks of it
THREADS = [2, 3, 8, 64]


def _raw(data: bytes, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    return c.compress(data) + c.flush()


FORMATS = {
    "zlib": lambda level: zlib.compress(DATA, level),
    "gzip": lambda level: gzip.compress(DATA, level, mtime=0),
    "raw": lambda level: _raw(DATA, level),
}


def _scan(blob: bytes, fmt: str, threads: int):
    if fmt == "gzip":
        return native.scan_members(blob, T, threads=threads)
    return native.scan_anchors(blob[2:] if fmt == "zlib" else blob, T,
                               threads=threads)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


SEARCH_BYTES = 256 << 10  # zzflate_native.c SPLIT_SEARCH_BYTES


def _taken(blocks, cuts, exact: bool) -> int:
    """The ranges a chain takes at these cuts, from the serial pass's
    blocks, for a stream with no bit the finder mistakes for a block
    start: range 0 where it begins at the stream's first bit (exact), and
    every range whose window (its cut to the next cut, at most
    SEARCH_BYTES) holds a non-final dynamic block's start."""
    member = blocks[:, 5] if blocks.shape[1] > 5 else np.zeros(len(blocks))
    last = np.r_[member[1:] != member[:-1], True]
    dyn = blocks[(blocks[:, 1] == 2) & ~last, 0]
    lo = 8 * np.r_[0, cuts]
    hi = np.minimum(8 * np.r_[cuts, 1 << 40], lo + 8 * SEARCH_BYTES)
    return sum(bool(k == 0 and exact) or bool(((dyn >= a) & (dyn < b)).any())
               for k, (a, b) in enumerate(zip(lo, hi)))


def _pieces(*parts) -> bytes:
    """One raw stream of the parts' blocks: each part (data, level,
    strategy) written by its own compressor and closed with a full flush,
    the last with the final block, so stored, fixed and dynamic blocks
    and empty stored flush blocks follow one another."""
    out = []
    for k, (data, level, strategy) in enumerate(parts):
        c = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
        last = k == len(parts) - 1
        out.append(c.compress(data)
                   + c.flush(zlib.Z_FINISH if last else zlib.Z_FULL_FLUSH))
    return b"".join(out)


def _mixed() -> bytes:
    return _pieces((DATA[:90000], 6, zlib.Z_DEFAULT_STRATEGY),
                   (DATA[90000:150000], 0, zlib.Z_DEFAULT_STRATEGY),
                   (DATA[150000:230000], 6, zlib.Z_FIXED),
                   (DATA[230000:330000], 1, zlib.Z_HUFFMAN_ONLY),
                   (DATA[330000:420000], 9, zlib.Z_RLE),
                   (DATA[420000:], 6, zlib.Z_DEFAULT_STRATEGY))


def _flushed() -> bytes:
    """One compressor, its window kept across sync flushes (empty stored
    blocks mid-stream) and reset at a full flush."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    out = []
    for k, o in enumerate(range(0, len(DATA), 70000)):
        out.append(c.compress(DATA[o:o + 70000]))
        out.append(c.flush(zlib.Z_FULL_FLUSH if k % 3 == 2
                           else zlib.Z_SYNC_FLUSH))
    return b"".join(out) + c.flush()


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_ranged_scan_equals_serial_scan(fmt, level, threads):
    blob = FORMATS[fmt](level)
    want = _scan(blob, fmt, 1)
    _same(_scan(blob, fmt, threads), want)
    if fmt == "gzip":
        got = native._scan_gzip_ranges(
            blob, T, native._cuts(0, len(blob), threads), threads)
    else:
        body = blob[2:] if fmt == "zlib" else blob
        got = native._scan_stream_ranges(
            body, T, native._cuts(0, len(body), threads), threads)
    _same(got[:4], want)
    cuts = native._cuts(0, len(blob) - (2 if fmt == "zlib" else 0), threads)
    assert got[4] == _taken(want[-3 if fmt == "gzip" else 0], cuts,
                            exact=fmt != "gzip")
    assert got[4] >= min(threads, 8) - 1


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("name", ["mixed", "flushed"])
def test_ranged_scan_over_stored_fixed_and_flushed_blocks(name, threads):
    """Blocks the finder passes over (stored, fixed, an empty flush) are
    scanned between the ranges it found."""
    raw = _mixed() if name == "mixed" else _flushed()
    assert zlib.decompress(raw, -15) == DATA
    want = native.scan_anchors(raw, T, threads=1)
    assert {0, 1, 2} <= set(want[0][:, 1].tolist())
    _same(native.scan_anchors(raw, T, threads=threads), want)


def _explicit(raw: bytes, cuts, threads: int = 3):
    """The ranged scan at explicit cuts against the serial pass; the count
    of ranges taken."""
    want = native.scan_anchors(raw, T, threads=1)
    got = native._scan_stream_ranges(raw, T, cuts, threads)
    _same(got[:4], want)
    return got[4]


def test_cuts_inside_stored_blocks():
    """Two ranges cut inside the level 0 part's stored block: the first
    finds no start before the second's cut, the second one past the fixed
    blocks that follow; the stored and fixed blocks are scanned between."""
    raw = _mixed()
    blocks = native.scan_anchors(raw, T, threads=1)[0]
    stored = blocks[(blocks[:, 1] == 0) & (blocks[:, 4] > 50000)]
    at = int(stored[0, 3])
    assert _explicit(raw, [at + 100, at + 30000]) == 2


def test_cut_one_byte_before_a_block_start():
    raw = FORMATS["raw"](6)
    blocks = native.scan_anchors(raw, T, threads=1)[0]
    starts = blocks[1:, 0]
    cuts = sorted({int(starts[k]) // 8 - 1 for k in (2, 5)})
    assert _explicit(raw, cuts) == 3


def test_range_past_its_first_room():
    """A token an anchor and ranges of ~1 KB: a range that begins on a
    block of ~16 000 tokens outgrows its first arrays (8 a byte of its
    share) and scans again with room; the answer is the serial pass's."""
    raw = FORMATS["raw"](6)
    want = native.scan_anchors(raw, 1, threads=1)
    got = native._scan_stream_ranges(raw, 1, native._cuts(0, len(raw), 200),
                                     4)
    _same(got[:4], want)
    assert np.diff(want[0][:, 0]).max() > 8 * 10 * len(raw) // 200
    assert got[4] >= 5


def test_final_block_before_the_last_cut():
    """A stream followed by bytes that are no part of it, the last ranges
    cut there: the answer ends at the final block, its trailing ranges
    left alone."""
    raw = FORMATS["raw"](6)
    junk = np.random.default_rng(5).integers(0, 256, 300000, np.uint8)
    blob = raw + _raw(DATA[:200000], 1) + junk.tobytes()
    cuts = native._cuts(0, len(blob), 6)
    assert cuts[-2] > len(raw)
    want = native.scan_anchors(blob, T, threads=1)
    assert want[3] <= 8 * len(raw)
    got = native._scan_stream_ranges(blob, T, cuts, 6)
    _same(got[:4], want)
    assert got[4] < 6


def test_planted_block_is_not_taken():
    """A whole dynamic block stored verbatim inside a stored block: the
    finder starts a range on it, and the answer is still the serial
    pass's (its records are never taken)."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    planted = c.compress(DATA[:100000]) + c.flush(zlib.Z_FULL_FLUSH)
    raw = _pieces((DATA[100000:200000], 6, zlib.Z_DEFAULT_STRATEGY),
                  (planted, 0, zlib.Z_DEFAULT_STRATEGY),
                  (DATA[200000:], 6, zlib.Z_DEFAULT_STRATEGY))
    at = raw.find(planted[:256])
    assert at > 0
    assert native._find_block(raw, 8 * at, 8 * (at + 1000)) == 8 * at
    taken = _explicit(raw, [at, at + len(planted) // 2 + 100000])
    assert taken == 2  # range 0 and the one past the planted data


def test_two_large_members_and_trailing_bytes():
    a, b = DATA[:300000], DATA[300000:]
    blob = (gzip.compress(a, 6, mtime=0) + gzip.compress(b, 1, mtime=0)
            + b"trailing bytes")
    want = native.scan_members(blob, T, threads=1)
    assert len(want[0]) == 2
    for threads in THREADS:
        _same(native.scan_members(blob, T, threads=threads), want)
    got = native._scan_gzip_ranges(blob, T, native._cuts(0, len(blob), 8), 8)
    _same(got[:4], want)
    assert got[4] >= 6


def test_finder_finds_the_next_dynamic_block():
    """From any cut, the finder's bit is the first dynamic block start at
    or after it that the serial pass records (zlib writes only complete
    codes, so it passes none)."""
    for level in (1, 6, 9):
        raw = _raw(DATA, level)
        blocks = native.scan_anchors(raw, T, threads=1)[0][:-1]  # non-final
        dyn = blocks[blocks[:, 1] == 2, 0]
        assert len(dyn) == len(blocks) >= 5
        for cut in range(0, int(dyn[-1]) // 8, 4999):
            want = dyn[np.searchsorted(dyn, 8 * cut)]
            assert native._find_block(raw, 8 * cut, 8 * len(raw)) == want
        assert native._find_block(raw, 8, int(dyn[1])) is None


# Verdicts: the serial pass's, the ranged scan rerunning it.
def _verdict(fn):
    try:
        return fn()
    except native.StreamError as e:
        return "StreamError", str(e)


def _flip(raw: bytes) -> bytes:
    """A bit flipped in the middle of the stream, the first one (by a
    fixed walk) after which the serial pass fails."""
    for k in range(len(raw) // 2, len(raw)):
        b = bytearray(raw)
        b[k] ^= 0x10
        try:
            native.scan_anchors(bytes(b), T, threads=1)
        except native.StreamError:
            return bytes(b)
    raise AssertionError("no flip breaks the stream")


@pytest.mark.parametrize("threads", [2, 8])
def test_flipped_bit_gives_the_serial_verdict(threads):
    bad = _flip(FORMATS["raw"](6))
    want = _verdict(lambda: native.scan_anchors(bad, T, threads=1))
    assert want[0] == "StreamError"
    assert _verdict(lambda: native.scan_anchors(bad, T, threads=threads)) == (
        want)
    assert native._scan_stream_ranges(
        bad, T, native._cuts(0, len(bad), threads), threads) is None


def _with_dict(dict_at_start: bool) -> tuple[bytes, bytes]:
    """A raw stream written with a preset dictionary, whose distances reach
    into it in its first block, or (dict_at_start False) first past a
    block of 3 literals ended by a sync flush, so in a later range."""
    zdict = DATA[-30000:]
    c = zlib.compressobj(6, zlib.DEFLATED, -15, zdict=zdict)
    lead = b"" if dict_at_start else c.compress(b"abc") + c.flush(
        zlib.Z_SYNC_FLUSH)
    return lead + c.compress(DATA[-30000:] + DATA) + c.flush(), zdict


@pytest.mark.parametrize("dict_at_start", [True, False])
def test_distance_before_the_stream_start(dict_at_start):
    raw, zdict = _with_dict(dict_at_start)
    assert zlib.decompressobj(-15, zdict=zdict).decompress(raw) == (
        zdict + DATA if dict_at_start else b"abc" + zdict + DATA)
    want = _verdict(lambda: native.scan_anchors(raw, T, threads=1))
    assert want == ("StreamError", "distance too far back")
    for threads in (2, 8):
        assert _verdict(lambda: native.scan_anchors(
            raw, T, threads=threads)) == want
    # With the dictionary's length every range is taken.
    cuts = [8] if not dict_at_start else [len(raw) // 2]
    want = native.scan_anchors(raw, T, dict_len=len(zdict), threads=1)
    got = native._scan_stream_ranges(raw, T, cuts, 2, dict_len=len(zdict))
    _same(got[:4], want)
    assert got[4] == 2
    _same(native.scan_anchors(raw, T, dict_len=len(zdict), threads=8), want)


@pytest.mark.parametrize("fmt", ["zlib", "gzip", "raw"])
def test_corrupt_stream_declines_device_decode(monkeypatch, fmt):
    """decompress_foreign returns None on a stream the scan finds corrupt,
    with the ranged scan (four cores, 64 KiB a range) as with the serial
    pass."""
    blob = FORMATS[fmt](6)
    head = {"zlib": 2, "gzip": 10, "raw": 0}[fmt]
    bad = blob[:head] + _flip(blob[head:])
    seen = []
    for split in (False, True):
        if split:
            monkeypatch.setattr(os, "sched_getaffinity",
                                lambda _pid: set(range(4)))
            monkeypatch.setattr(native, "SPLIT_MIN_BYTES", 1 << 16)
        names, _ms = _spans(lambda: seen.append(
            idv.decompress_foreign(bad, format=fmt, device="cpu")))
        assert ("decode_scan_stream_split" in names) == split
    assert seen == [None, None]


def _bgzf(data: bytes, block: int = 0xFF00) -> bytes:
    """data in BGZF members: FEXTRA's BC subfield holds BSIZE."""
    out = []
    for o in range(0, len(data), block):
        piece = data[o:o + block]
        body = _raw(piece, 6)
        out.append(b"\x1f\x8b\x08\x04" + bytes(4) + b"\x00\xff"
                   + struct.pack("<HBBHH", 6, 66, 67, 2, len(body) + 25)
                   + body + struct.pack("<II", zlib.crc32(piece),
                                        len(piece)))
    return b"".join(out)


def _spans(fn) -> tuple[list, dict]:
    names = []
    with profiling.collect() as timer:
        orig = timer.stage

        def stage(nm, device=None):
            names.append(nm)
            return orig(nm, device)

        timer.stage = stage
        fn()
    return names, timer.as_ms()


def test_decode_scan_stream_split_span(monkeypatch):
    """decode_scan_stream_split, inside decode_scan, for a 4 MiB stream on
    four cores; not for a small stream, nor for BGZF, whose members scan in
    ranges of members."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda _pid: set(range(4)))
    noise = np.random.default_rng(4).integers(0, 256, 3 << 19, np.uint8)
    big = mixed_corpus(5 << 19, 28) + noise.tobytes()
    blob = zlib.compress(big, 6)
    assert len(blob) >= 2 * native.SPLIT_MIN_BYTES
    names, ms = _spans(lambda: idv.decompress_foreign(
        blob, format="zlib", device="cpu") == big or pytest.fail("bytes"))
    assert names.count("decode_scan_stream_split") == 1
    assert names.index("decode_scan") < names.index(
        "decode_scan_stream_split") < names.index("decode_plan")
    assert 0 < ms["decode_scan_stream_split"] <= ms["decode_scan"]

    small = zlib.compress(DATA, 6)
    names, _ms = _spans(lambda: idv.decompress_foreign(
        small, format="zlib", device="cpu") == DATA or pytest.fail("bytes"))
    assert "decode_scan" in names
    assert "decode_scan_stream_split" not in names

    names, _ms = _spans(lambda: native.scan_members(_bgzf(big), T))
    assert names == ["decode_scan_split"]
