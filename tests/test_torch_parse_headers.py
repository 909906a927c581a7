"""The C block-header parse of the device decode's plan
(``native.parse_headers``, ``zzt_parse_headers`` in
``native/zzflate_native.c``) against the Python parse it replaced on the
planners' path, on the CPU.

The oracle is ``models/inflate.py``'s ``_read_dynamic_tables`` and
``CanonicalDecoder`` with ``inflate_device._canon_desc``: block by block,
the same descriptors and header end bits on real streams (stdlib gzip
members, zlib's fixed blocks, the port's own indexed output), and the
same verdict on planted headers (accepted, the same ValueError, or
IndexError where the Python bit reader runs past the segment).
``_plan_units`` is held to the Python planner it replaced, and the
public decoders to their old verdicts on a header cut at its segment's
end."""
import functools
import gzip
import io
import zlib

import numpy as np
import pytest
import torch

import zzflate_tpu_torch as zt
from zzflate_tpu_torch import constants as C
from zzflate_tpu_torch import native
from zzflate_tpu_torch.models import inflate_device as idv
from zzflate_tpu_torch.models.inflate import BitReader, _read_dynamic_tables
from zzflate_tpu_torch.utils import containers
from zzflate_tpu_torch.utils.corpus import mixed_corpus

# One thread apiece: the test processes share the CPU.
torch.set_num_threads(1)

CHUNK = 4096


def _py_header(body: bytes, bit0: int):
    """The Python parse of one block header: (first token's bit, ll
    descriptors, d descriptors), as the planners made them before the C
    parse."""
    b = BitReader(body, bit0)
    b.bits(1)
    btype = b.bits(2)
    if btype == 1:
        lld, dd = idv._FixedDecs.get()
    elif btype == 2:
        lld, dd = _read_dynamic_tables(b)
    else:
        raise ValueError("bad BTYPE")
    return (b.bitpos, idv._canon_desc(lld, idv._MAX_LL),
            idv._canon_desc(dd, idv._MAX_D))


def _verdict(fn):
    """fn()'s result, or the exception's type and, for ValueError, its
    words."""
    try:
        return fn()
    except IndexError:
        return "IndexError"
    except ValueError as e:
        return f"ValueError: {e}"


def _assert_same_headers(body: bytes, bits, ends):
    """The C parse of every block equals the Python parse of the block's
    segment."""
    hdr_end, ll, d = native.parse_headers(body, bits, ends)
    assert len(hdr_end) == len(bits) > 0
    for j, (bit0, end) in enumerate(zip(bits, np.broadcast_to(ends,
                                                              len(bits)))):
        bit, lld, dd = _py_header(body[: int(end)], int(bit0))
        assert hdr_end[j] == bit, j
        for got, exp in zip((*ll, *d), (*lld, *dd)):
            np.testing.assert_array_equal(got[j], exp)
            assert got.dtype == np.int32


# ---------------------------------------------------------------------------
# Real streams.
# ---------------------------------------------------------------------------


def _gzip_member(data: bytes, level: int) -> bytes:
    bio = io.BytesIO()
    with gzip.GzipFile(filename="shard-00000.jsonl", mode="wb",
                       compresslevel=level, fileobj=bio, mtime=0) as f:
        f.write(data)
    return bio.getvalue()


def _coded_blocks(body: bytes) -> np.ndarray:
    blocks, _anchors, _n, _end = native.scan_anchors(body, 64)
    return blocks[blocks[:, 1] != 0, 0]


@pytest.mark.parametrize("level", [1, 6, 9])
def test_stdlib_gzip_members_match_python_parse(level):
    blob = _gzip_member(mixed_corpus(1 << 20, level), level)
    assert blob[3] & 0x08  # FNAME
    body = blob[containers.parse_gzip_header(blob):]
    bits = _coded_blocks(body)
    assert len(bits) >= 4
    _assert_same_headers(body, bits, len(body))


def test_zlib_fixed_blocks_match_python_parse():
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_FIXED)
    data = mixed_corpus(300000, 2)
    blob = co.compress(data) + co.flush()
    body = blob[2:]
    blocks, _a, n, _e = native.scan_anchors(body, 64)
    assert n == len(data) and (blocks[:, 1] == 1).all() and len(blocks) > 1
    _assert_same_headers(body, blocks[:, 0], len(body))


@functools.lru_cache(maxsize=None)
def _indexed(level: int) -> tuple[bytes, bytes]:
    data = mixed_corpus(3 * CHUNK + 700, 40 + level)
    return data, zt.compress(data, level=level, format="gzip",
                             chunk_bytes=CHUNK, indexed=True, device="cpu")


def _plan_units_py(body, chunks, out_starts, out_sizes):
    """_plan_units as it was before the C parse: the Python parse of
    every block of every coded chunk, in order."""
    units, stored_runs, unit_ranges = [], [], []
    pos = 0
    for i, (sz, blocks, _anchors) in enumerate(chunks):
        seg = body[pos : pos + sz]
        seg0 = pos
        pos += sz
        ulo = len(units)
        br = BitReader(seg, 0)
        br.bits(1)
        if br.bits(2) == 0:
            stored_runs.extend(
                idv._stored_runs(seg, out_starts[i], out_sizes[i], seg0))
            unit_ranges.append((ulo, ulo))
            continue
        for bit_off, out_off in blocks:
            bit, lld, dd = _py_header(seg, bit_off)
            units.append((seg0 * 8 + bit, out_starts[i] + out_off, lld, dd))
        unit_ranges.append((ulo, len(units)))
    return units, stored_runs, unit_ranges


def _plan_args(level: int):
    data, blob = _indexed(level)
    header_len, cb, _t, chunks = containers.parse_gzip_index(blob)
    starts = [idv._W + i * cb for i in range(len(chunks))]
    sizes = [min(cb, max(0, len(data) - i * cb)) for i in range(len(chunks))]
    return blob[header_len:-8], chunks, starts, sizes


def _assert_plans_equal(got, exp):
    bits, outs, ll, d, runs, ranges = got
    units, e_runs, e_ranges = exp
    assert runs.tolist() == [list(r) for r in e_runs]
    assert ranges.tolist() == [list(r) for r in e_ranges]
    assert len(bits) == len(outs) == len(units)
    for j, (bit, out_base, lld, dd) in enumerate(units):
        assert (bits[j], outs[j]) == (bit, out_base)
        for ga, ea in zip((*ll, *d), (*lld, *dd)):
            np.testing.assert_array_equal(ga[j], ea)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_indexed_output_matches_python_parse(level):
    """The port's own indexed members: each block bounded by its chunk's
    end, and the whole plan as the Python planner made it."""
    body, chunks, starts, sizes = _plan_args(level)
    bits, ends, pos = [], [], 0
    for sz, blocks, _anchors in chunks:
        bits += [pos * 8 + b for b, _o in blocks]
        ends += [pos + sz] * len(blocks)
        pos += sz
    _assert_same_headers(body, bits, ends)
    got = idv._plan_units(body, chunks, starts, sizes)
    assert len(got[0]) > 0
    _assert_plans_equal(got, _plan_units_py(body, chunks, starts, sizes))


# ---------------------------------------------------------------------------
# Planted headers.
# ---------------------------------------------------------------------------


class _Bits:
    """An LSB-first bit writer; Huffman codes go MSB-first."""

    def __init__(self):
        self.v = 0
        self.n = 0

    def put(self, value: int, k: int) -> None:
        self.v |= value << self.n
        self.n += k

    def code(self, code: int, k: int) -> None:
        self.put(int(f"{code:0{k}b}"[::-1], 2) if k else 0, k)

    def bytes(self) -> bytes:
        return self.v.to_bytes((self.n + 7) // 8, "little")


_EXTRA = {16: 2, 17: 3, 18: 7}


def _rle(lens):
    """Code-length symbols (sym, extra) for a list of lengths."""
    out, i = [], 0
    while i < len(lens):
        v, run = lens[i], 1
        while i + run < len(lens) and lens[i + run] == v:
            run += 1
        if v == 0 and run >= 11:
            r = min(run, 138)
            out.append((18, r - 11))
        elif v == 0 and run >= 3:
            r = min(run, 10)
            out.append((17, r - 3))
        else:
            out.append((v, 0))
            r = 1
            if run > 3:
                out.append((16, min(run - 1, 6) - 3))
                r += min(run - 1, 6)
        i += r
    return out


CL_ALL = [5] * 19  # every code-length symbol, 5 bits: an incomplete code
LL_OK = [9] * 256 + [1]  # a complete litlen code: hlit 257
D_OK = [1, 1]


def _header(ll=LL_OK, d=D_OK, cl=CL_ALL, syms=None, hlit=None, hdist=None,
            hclen=19, btype=2) -> bytes:
    """One block header (BFINAL set) followed by 8 bytes of ones."""
    w = _Bits()
    w.put(1, 1)
    w.put(btype, 2)
    if btype == 2:
        w.put((hlit or len(ll)) - 257, 5)
        w.put((hdist or len(d)) - 1, 5)
        w.put(hclen - 4, 4)
        for i in range(hclen):
            w.put(cl[int(C.CL_ORDER[i])], 3)
        syms = _rle(list(ll) + list(d)) if syms is None else syms
        codes = C.canonical_codes(np.array(cl, np.int32)) if syms else None
        for s, extra in syms:
            w.code(int(codes[s]), cl[s])
            if s in _EXTRA:
                w.put(extra, _EXTRA[s])
    return w.bytes() + b"\xff" * 8


def _cl_two_codes():
    """A code-length code with only symbols 8 and 9 (codes 00, 01)."""
    cl = [0] * 19
    cl[8] = cl[9] = 2
    return cl


PLANTED = {
    # accepted
    "hlit287": dict(ll=[9] * 256 + [2] + [0] * 29 + [2]),
    "hlit288": dict(ll=[9] * 256 + [2] + [0] * 30 + [2]),
    "hdist31": dict(d=[0] * 29 + [1, 1]),
    "hdist32": dict(d=[0] * 30 + [1, 1]),
    "incomplete_litlen": dict(ll=[9] * 256 + [2]),
    "empty_dist": dict(d=[0]),
    "empty_codes_short_hclen": dict(hclen=4, cl=[2] + [0] * 15 + [2, 2, 2],
                                    ll=[0] * 257, d=[0]),
    "fixed": dict(btype=1),
    # rejected
    "oversub_cl": dict(cl=[1, 1, 1] + [0] * 16, syms=[]),
    "oversub_litlen": dict(ll=[8] * 257),
    "oversub_dist": dict(d=[1, 1, 1]),
    "repeat16_first": dict(syms=[(16, 0)] + _rle(LL_OK + D_OK)),
    "code_length_overrun": dict(syms=_rle(LL_OK + [1]) + [(18, 127)]),
    "all_zero_cl": dict(cl=[0] * 19, hclen=4, syms=[]),
    "invalid_cl_symbol": dict(cl=_cl_two_codes(), ll=[8] * 257, d=[9, 9],
                              syms=[(8, 0), (9, 0)]),
    "btype0": dict(btype=0),
    "btype3": dict(btype=3),
}


@pytest.mark.parametrize("name", list(PLANTED))
def test_planted_header_verdict_matches_python_parse(name):
    hdr = _header(**PLANTED[name])
    for bit0 in (0, 5):  # byte-aligned and not
        body = bytes([0x5A]) + (int.from_bytes(hdr, "little") << bit0)\
            .to_bytes(len(hdr) + 1, "little")
        start = 8 + bit0
        exp = _verdict(lambda: _py_header(body, start))
        got = _verdict(lambda: native.parse_headers(body, [start],
                                                    len(body)))
        if isinstance(exp, str):
            assert got == exp, (name, bit0)
            continue
        assert not isinstance(got, str), (name, got)
        bit, lld, dd = exp
        hdr_end, ll, d = got
        assert hdr_end[0] == bit
        for g, e in zip((*ll, *d), (*lld, *dd)):
            np.testing.assert_array_equal(g[0], e)
    accepted = name in ("hlit287", "hlit288", "hdist31", "hdist32",
                        "incomplete_litlen", "empty_dist",
                        "empty_codes_short_hclen",
                        "fixed")
    assert accepted == (not isinstance(exp, str)), (name, exp)


def test_planted_rejections_are_each_their_own():
    """Each rejected case fails for its own reason."""
    got = {}
    for name, kw in PLANTED.items():
        hdr = _header(**kw)
        got[name] = _verdict(lambda: native.parse_headers(hdr, [0], len(hdr)))
    assert got["oversub_cl"] == got["oversub_litlen"] == got[
        "oversub_dist"] == "ValueError: over-subscribed Huffman code"
    assert got["repeat16_first"] == "ValueError: repeat with no previous " \
        "length"
    assert got["code_length_overrun"] == "ValueError: code length overrun"
    assert got["all_zero_cl"] == got["invalid_cl_symbol"] == (
        "ValueError: invalid Huffman code")
    assert got["btype0"] == got["btype3"] == "ValueError: bad BTYPE"


@pytest.mark.parametrize("kind", ["dynamic", "fixed"])
def test_header_cut_at_every_bit_of_its_segment(kind):
    """A segment ending anywhere inside the header: IndexError, as the
    Python bit reader; ending at the header's last byte or later: the
    descriptors. The C parse reads only its segment."""
    hdr = _header() if kind == "dynamic" else _header(btype=1)
    full = native.parse_headers(hdr, [0], len(hdr))[0][0]
    for end in range(0, (full + 7) // 8 + 2):
        exp = _verdict(lambda: _py_header(hdr[:end], 0))
        got = _verdict(lambda: native.parse_headers(hdr, [0], end))
        if end * 8 < full:
            assert exp == got == "IndexError", end
        else:
            assert not isinstance(got, str) and got[0][0] == full == exp[0]
    # A start at or past the segment's end, or before the body.
    for start, end in ((8 * len(hdr), len(hdr)), (8 * len(hdr) - 2,
                                                  len(hdr)), (-1, 4)):
        assert _verdict(lambda: native.parse_headers(
            hdr, [start], end)) == "IndexError"


def test_batch_stops_at_the_first_bad_block():
    """Blocks after a bad one are not read: the first error wins, as the
    Python planners raised at the first bad block."""
    good = _header()
    bad_sub = _header(d=[1, 1, 1])
    bad_cut = _header()
    body = good + bad_sub + bad_cut
    starts = [0, 8 * len(good), 8 * (len(good) + len(bad_sub))]
    assert _verdict(lambda: native.parse_headers(
        body, starts, [len(good), len(good) + len(bad_sub), len(body)])) \
        == "ValueError: over-subscribed Huffman code"
    assert _verdict(lambda: native.parse_headers(
        body, starts[::2], [len(good), len(good) + 3])) == "IndexError"
    hdr_end, ll, d = native.parse_headers(body, [0], len(body))
    assert hdr_end.shape == (1,) and ll[3].shape == (1, 288)
    assert d[3].shape == (1, 32)
    empty = native.parse_headers(body, [], len(body))
    assert empty[0].shape == (0,) and empty[1][0].shape == (0, 16)


# ---------------------------------------------------------------------------
# The planners' verdicts on a header cut at its segment's end.
# ---------------------------------------------------------------------------


def _with_blocks(blob: bytes, ci: int, blocks) -> bytes:
    """blob with chunk ci's block records replaced."""
    header_len, cb, _t, chunks = containers.parse_gzip_index(blob)
    chunks = [(sz, list(blocks) if i == ci else b, a)
              for i, (sz, b, a) in enumerate(chunks)]
    return containers.gzip_header_indexed(cb, chunks) + blob[header_len:]


def _first_coded_chunk(blob: bytes) -> int:
    header_len, _cb, _t, chunks = containers.parse_gzip_index(blob)
    pos = header_len
    for i, (sz, _b, _a) in enumerate(chunks):
        if (blob[pos] >> 1) & 3:
            return i
        pos += sz
    raise AssertionError("no coded chunk")


def test_indexed_header_past_its_segment_raises_corrupt_segment():
    data, blob = _indexed(6)
    ci = _first_coded_chunk(blob)
    _h, _cb, _t, chunks = containers.parse_gzip_index(blob)
    sz = chunks[ci][0]
    # Two bits before the segment's end: BFINAL and one BTYPE bit fit.
    bad = _with_blocks(blob, ci, [(8 * sz - 2, 0)])
    assert containers.parse_gzip_index(bad)[3][ci][1] == [(8 * sz - 2, 0)]
    with pytest.raises(ValueError, match="corrupt indexed segment"):
        idv.decompress_indexed(bad, device="cpu")
    assert idv.decompress_indexed(blob, device="cpu") == data


def test_plan_units_raises_the_first_fault_in_chunk_order():
    """A bad header in one chunk and an empty segment after it: the
    header's ValueError, as the Python planner raised it first; the empty
    segment alone: IndexError, as before."""
    body, chunks, starts, sizes = _plan_args(6)
    ci = _first_coded_chunk(_indexed(6)[1])
    sz = chunks[ci][0]
    hostile = [(sz, [(8 * sz - 2, 0)] if i == ci else b, a)
               for i, (sz, b, a) in enumerate(chunks)]
    cut = hostile[: ci + 1] + [(0, [], [])]
    for case, want in ((cut, "IndexError"),
                       (chunks[:ci] + [(0, [], [])], "IndexError")):
        args = (body, case, starts, sizes)
        assert _verdict(lambda: idv._plan_units(*args)) == want == _verdict(
            lambda: _plan_units_py(*args))
    bad_hdr = _header(d=[1, 1, 1])
    sub = bad_hdr + b"\x00" * 4
    args = (sub, [(len(sub), [(0, 0)], []), (0, [], [])], starts, sizes)
    assert _verdict(lambda: idv._plan_units(*args)) == _verdict(
        lambda: _plan_units_py(*args)) == (
        "ValueError: over-subscribed Huffman code")


def test_foreign_header_cut_declines_as_before():
    """A stdlib member cut inside a block header: the scan finds it, so
    decompress_foreign declines (None) without parsing a header, and the
    host decoder raises."""
    blob = _gzip_member(mixed_corpus(200000, 8), 6)
    hl = containers.parse_gzip_header(blob)
    bits = _coded_blocks(blob[hl:])
    assert len(bits) >= 2
    cut = blob[: hl + int(bits[1]) // 8 + 3]
    assert idv.decompress_foreign(cut, format="gzip", device="cpu") is None
    with pytest.raises((EOFError, zlib.error)):
        gzip.decompress(cut)
    # The whole member still decodes.
    assert idv.decompress_foreign(blob, format="gzip", device="cpu") == \
        gzip.decompress(blob)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mutated_headers_match_python_parse(seed):
    """Real headers with one bit flipped and cut at a random byte: the
    same verdict, and where both accept, the same descriptors."""
    rng = np.random.default_rng(seed)
    blob = _gzip_member(mixed_corpus(1 << 19, seed), 6)
    body = blob[containers.parse_gzip_header(blob):]
    bits = _coded_blocks(body)
    hdr_end = native.parse_headers(body, bits, len(body))[0]
    seen = set()
    for _ in range(150):
        k = int(rng.integers(len(bits)))
        b0, b1 = int(bits[k]), int(hdr_end[k])
        flip = int(rng.integers(b0, b1))
        mutated = bytearray(body[b0 // 8 : b1 // 8 + 8])
        mutated[flip // 8 - b0 // 8] ^= 1 << (flip % 8)
        end = int(rng.integers(1, len(mutated) + 1))
        seg, start = bytes(mutated[:end]), b0 % 8
        exp = _verdict(lambda: _py_header(seg, start))
        got = _verdict(lambda: native.parse_headers(seg, [start], end))
        if isinstance(exp, str):
            assert got == exp, (k, flip, end)
        else:
            assert got[0][0] == exp[0]
            for g, e in zip((*got[1], *got[2]), (*exp[1], *exp[2])):
                np.testing.assert_array_equal(g[0], e)
        seen.add(exp if isinstance(exp, str) else "accepted")
    assert {"accepted", "IndexError"} < seen and len(seen) >= 4, seen
