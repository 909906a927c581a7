"""Device decode of zzflate_tpu_torch (models/inflate_device.py) against
the JAX package's models/inflate_tpu.py, on the CPU.

Per module: the device CRC-32 and Adler-32, the canonical symbol decode,
the anchor walk's output-space arrays, the LZ resolve, the host plan
and every group's staged inputs, and the per-bit path of v2 indexes.
Whole calls: decompress_indexed and decompress_foreign on the inputs of
every case of tests/test_inflate_tpu.py and tests/test_inflate_foreign.py
give the reference's bytes, its None, or both raise ValueError; the
public decompress(engine="device", device="cpu") gives what the
reference's engine="tpu" gives. A numpy mirror of csrc/walk.cu's
per-lane loop is held against the walk's plain version. Tolerance is
zero: decode is integer-only and deterministic.

Cost: the reference compiles its CRC graph for about 20 s per shape on
the CPU, and its walk graph without the CRC in about 2 s. So the
reference decodes with verify=False where the bytes are compared (the
port always verifies its CRC), its CRC is held against the port's on
one shape that covers every length, and it runs with its CRC on one
corrupt stream and one public gzip route. Indexed inputs come from the
port's compress(..., indexed=True, device="cpu"), whose bytes equal the
reference encoder's (tests/test_torch_api.py).
"""
import glob
import gzip
import struct
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import zzflate_tpu as zf
import zzflate_tpu_torch as zt
from zzflate_tpu_torch import native
from zzflate_tpu.models import inflate_tpu as ref
from zzflate_tpu.ops import checksums as rcs
from zzflate_tpu_torch.constants import ANCHOR_TOKENS
from zzflate_tpu_torch.models import inflate_device as idv
from zzflate_tpu_torch.ops import canonical as canon
from zzflate_tpu_torch.ops import checksums as cs
from zzflate_tpu_torch.ops import kernels
from zzflate_tpu_torch.utils import containers

# The test processes share the CPU. With torch's default intra-op pool in
# each of them it is oversubscribed, and a CPU-path call runs tens of
# times slower; one thread apiece keeps the suite inside its time limit.
torch.set_num_threads(1)

CHUNK = 4096
M32 = 0xFFFFFFFF


def _indexed(data, level=6, chunk=CHUNK):
    return zt.compress(data, level=level, format="gzip", chunk_bytes=chunk,
                       indexed=True, device="cpu")


def _outcome(fn):
    """fn()'s bytes, None, or 'ValueError'."""
    try:
        return fn()
    except ValueError:
        return "ValueError"


# ---------------------------------------------------------------------------
# Streams: the inputs of tests/test_inflate_tpu.py and
# tests/test_inflate_foreign.py (module-scoped: each is encoded once).
# ---------------------------------------------------------------------------


def _headers_text(n):
    parts = []
    for p in sorted(glob.glob("/usr/include/*.h"))[:40]:
        try:
            parts.append(open(p, "rb").read())
        except OSError:
            pass
    return b"".join(parts)[:n]


def _walk_mixed():
    rng = np.random.default_rng(9)
    return (b"dyn text block " * 600
            + rng.integers(0, 256, CHUNK, dtype=np.uint8).tobytes() + b"ab")


def _grouped():
    rng = np.random.default_rng(9)
    lump = rng.integers(0, 64, size=3000, dtype=np.uint8).tobytes()
    return ((b"grouped walk seam stress 0123456789 " * 900)[:24000]
            + lump * 8 + b"\x00" * 40000 + (lump[:640] * 120))


def _mixed_stored():
    rng = np.random.default_rng(4)
    rnd = rng.integers(0, 256, size=CHUNK * 2, dtype=np.uint8).tobytes()
    return rnd + b"compressible text region " * 400 + rnd


def _v2(out):
    """The same body behind a legacy v2 'ZZ' subfield (no anchors)."""
    header_len, cb, _t, chunks = containers.parse_gzip_index(out)
    sub = bytearray(struct.pack("<BBII", 2, 0, cb, len(chunks)))
    for seg_bytes, blocks, _anchors in chunks:
        sub += struct.pack("<IH", seg_bytes, len(blocks))
        for bit_off, out_off in blocks:
            sub += struct.pack("<II", bit_off, out_off)
    extra = b"ZZ" + struct.pack("<H", len(sub)) + bytes(sub)
    hdr = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
           + struct.pack("<H", len(extra)) + extra)
    return hdr + out[header_len:]


# name -> (data, stream): tests/test_inflate_tpu.py's inputs.
INDEXED = {
    "text_multichunk": lambda: (b"speculative parallel decode " * 2000)[:40000],
    "cross_chunk_halo": lambda: (b"0123456789abcdefgh" * 31)[:558] * 40,
    "rle_zeros": lambda: b"\x00" * 50000,
    "rle_ab": lambda: b"ab" * 30000,
    "stored_fallback": lambda: np.random.default_rng(3).integers(
        0, 256, size=30000, dtype=np.uint8).tobytes(),
    "mixed_stored_and_coded": _mixed_stored,
    "empty": lambda: b"",
    "one_byte": lambda: b"x",
    "hello": lambda: b"hello world",
    "defer": lambda: (b"defer scatter equivalence corpus 0123456789 "
                      * 1500)[:60000],
    "walk_nolut_mixed": _walk_mixed,
}


@pytest.fixture(scope="module")
def streams():
    out = {name: (mk(), None) for name, mk in INDEXED.items()}
    out = {name: (d, _indexed(d)) for name, (d, _) in out.items()}
    body = (b"level parametrized body " * 1500)[:30000]
    for level in (1, 6, 9):
        out[f"level{level}"] = (body, _indexed(body, level))
    d = (b"multi sub-block indexed segment " * 9000)[:260000]
    out["multi_subblock"] = (d, _indexed(d, chunk=1 << 17))
    d = _headers_text(260000)
    out["boundary_crossing"] = (d, _indexed(d, chunk=1 << 17))
    d = np.random.default_rng(5).integers(0, 16, size=400_000,
                                          dtype=np.uint8).tobytes()
    out["anchor_long_blocks"] = (d, _indexed(d, chunk=1 << 17))
    d = _grouped()
    out["grouped"] = (d, _indexed(d, chunk=16384))
    return out


@pytest.fixture(scope="module")
def mixed():
    text = (open("/usr/include/zlib.h", "rb").read() * 6)[: 1 << 19]
    rnd = np.random.default_rng(3).integers(
        0, 256, 1 << 15, dtype=np.uint8
    ).tobytes()
    return text + rnd + text[:50000]


# ---------------------------------------------------------------------------
# Checksums.
# ---------------------------------------------------------------------------

# One padded shape for every length: the reference's _crc32_impl takes
# the length and start as arrays, so one compile covers them all.
CRC_PAD = 1 << 17


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 70000])
def test_checksums_match_reference(n):
    rng = np.random.default_rng(n)
    d = rng.integers(0, 256, n, dtype=np.uint8)
    padded = np.zeros(CRC_PAD, np.uint8)
    padded[:n] = d
    for start in sorted({0, min(n, 1), min(n, 7), n // 2}):
        exp = int(rcs._crc32_impl(jnp.asarray(padded), jnp.int32(n),
                                  jnp.int32(start)))
        assert exp == zlib.crc32(d[start:].tobytes())
        got = cs.crc32(torch.from_numpy(d), n, start)
        assert got.dtype == torch.int64 and got.dim() == 0
        assert int(got) == exp
        assert int(cs._crc32_impl(torch.from_numpy(padded), n, start)) == exp
        exp = int(rcs.adler32(d, n, start))
        got = cs.adler32(torch.from_numpy(d), n, start)
        assert got.dtype == torch.int64 and got.dim() == 0
        assert int(got) == exp == zlib.adler32(d[start:].tobytes())
    if n > 10:
        got = cs.crc32(torch.from_numpy(d), n - 3, 2)
        assert int(got) == zlib.crc32(d[2 : n - 3].tobytes())


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 100_000])
def test_running_max_equals_torch_cummax(n):
    g = torch.Generator().manual_seed(n)
    for dtype in (torch.int32, torch.int64):
        x = torch.randint(-5000, 5000, (n,), generator=g).to(dtype)
        x[::7] = -1
        assert torch.equal(idv._cummax(x), torch.cummax(x, 0).values)


# ---------------------------------------------------------------------------
# Symbol decode.
# ---------------------------------------------------------------------------


def _unit_descs(data):
    """(U, 16) x 3 + (U, nsym) descriptors of every block of a stream."""
    blob = _indexed(data)
    header_len, cb, _t, chunks = containers.parse_gzip_index(blob)
    body = blob[header_len:-8]
    n = len(data)
    starts = [i * cb for i in range(len(chunks))]
    sizes = [min(cb, max(0, n - s)) for s in starts]
    _bits, _outs, ll, d, _runs, _ranges = idv._plan_units(body, chunks,
                                                          starts, sizes)
    return list(ll), list(d)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_bits_canon_matches_reference(seed):
    ll, d = _unit_descs(_walk_mixed())
    u = ll[0].shape[0]
    rng = np.random.default_rng(seed)
    n = 4000
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    uid = rng.integers(0, u, n).astype(np.int32)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    exp = ref._decode_bits_canon(
        j(lo), j(hi), j(uid),
        ref._canon_lane_tables(j(ll[0]), j(ll[1]), j(ll[2]), j(uid)),
        ref._canon_lane_tables(j(d[0]), j(d[1]), j(d[2]), j(uid)),
        j(ll[3]).reshape(-1), j(d[3]).reshape(-1),
    )
    t = torch.from_numpy
    tu = t(uid).long()
    got = canon._decode_bits_canon(
        t(lo.astype(np.int64)), t(hi.astype(np.int64)), tu,
        canon._canon_lane_tables(
            canon._canon_unit_tables(t(ll[0]), t(ll[1]), t(ll[2])), tu),
        canon._canon_lane_tables(
            canon._canon_unit_tables(t(d[0]), t(d[1]), t(d[2])), tu),
        t(ll[3]).long().reshape(-1), t(d[3]).long().reshape(-1),
    )
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    step = got[0].numpy()
    assert (step == canon._HUGE).any()  # EOB and invalid windows occur
    assert ((step > 0) & (step <= 48)).any()
    assert got[5].numpy().any() and got[4].numpy().any()


# ---------------------------------------------------------------------------
# One real group: the staged inputs, the walk and the resolve.
# ---------------------------------------------------------------------------


def _capture_port(monkeypatch, blob, **kw):
    """Every group's (arrs, prefix, crc_len, n_out_pad, n_stored, t_steps)
    as the port's decompress_indexed hands them to _walk_all."""
    calls = []
    orig = idv._walk_all

    def rec(arrs, prefix, crc_len, n_out_pad, n_stored, t_steps, with_crc):
        calls.append((dict(arrs), prefix.clone(), crc_len, n_out_pad,
                      n_stored, t_steps))
        return orig(arrs, prefix, crc_len, n_out_pad, n_stored, t_steps,
                    with_crc)

    monkeypatch.setattr(idv, "_walk_all", rec)
    out = idv.decompress_indexed(blob, device="cpu", **kw)
    monkeypatch.setattr(idv, "_walk_all", orig)
    return out, calls


_WALK_KEYS = ("words", "ll_first", "ll_cnt", "ll_off", "ll_sym", "d_first",
              "d_cnt", "d_off", "d_sym", "lane_bit", "lane_out", "lane_uid",
              "lane_valid")


def _ref_args(arrs, prefix):
    """The reference _walk_core's array arguments from the port's."""
    a = [jnp.asarray(arrs[k].numpy()) for k in _WALK_KEYS]
    a[0] = jnp.asarray(arrs["words"].numpy().view(np.uint32))
    a[12] = a[12].astype(bool)
    return a + [jnp.asarray(prefix.numpy()), jnp.asarray(arrs["sr"].numpy())]


def _port_args(arrs, prefix):
    return [arrs[k] for k in _WALK_KEYS] + [prefix, arrs["sr"]]


_ref_walk_core = jax.jit(ref._walk_core, static_argnums=(15, 16, 17, 18))


@pytest.fixture(scope="module")
def real_group():
    data = _walk_mixed()
    mp = pytest.MonkeyPatch()
    try:
        out, calls = _capture_port(mp, _indexed(data))
    finally:
        mp.undo()
    assert out == data and len(calls) == 1
    return calls[0]


def test_walk_core_and_resolve_match_reference(real_group):
    arrs, prefix, _crc_len, n_out_pad, n_stored, t_steps = real_group
    assert n_stored > 0  # the group holds stored runs and coded blocks
    exp = _ref_walk_core(*_ref_args(arrs, prefix), n_out_pad, n_stored,
                         t_steps, True)
    got = idv._walk_core(*_port_args(arrs, prefix), n_out_pad, n_stored,
                         t_steps)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    litval, start_mark, dist_at = got
    assert (dist_at.numpy() > 0).any()  # matches were decoded
    parent, rounds = idv._resolve_parent(start_mark, dist_at, n_out_pad)
    exp_parent = jax.jit(ref._resolve_parent, static_argnums=2)(
        jnp.asarray(start_mark.numpy()), jnp.asarray(dist_at.numpy()),
        n_out_pad)
    np.testing.assert_array_equal(parent.numpy(), np.asarray(exp_parent))
    assert 1 <= rounds <= 40


def _hostile_walk_input(arrs, seed):
    """The real group's tables with seeded words (mostly invalid windows),
    lanes at random bits, some past the output's end, some with a unit id
    out of range, some invalid."""
    rng = np.random.default_rng(seed)
    nw = arrs["words"].shape[0]
    n_lanes = 200
    n_out_pad = 1 << 16
    words = rng.integers(0, 1 << 32, nw, dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    real = arrs["words"].numpy()
    words[: nw // 2] = real[: nw // 2]  # half of it real code
    u = arrs["ll_first"].shape[0]
    lanes = {
        "lane_bit": rng.integers(0, 32 * nw, n_lanes),
        "lane_out": np.where(rng.random(n_lanes) < 0.2,
                             rng.integers(n_out_pad - 50, n_out_pad + 500,
                                          n_lanes),
                             rng.integers(0, n_out_pad, n_lanes)),
        "lane_uid": rng.integers(-2, u + 3, n_lanes),
        "lane_valid": (rng.random(n_lanes) < 0.9).astype(np.int32),
    }
    out = dict(arrs)
    out["words"] = torch.from_numpy(words.copy())
    for k, v in lanes.items():
        out[k] = torch.from_numpy(v.astype(np.int32))
    return out, n_out_pad


def test_walk_core_on_hostile_input_matches_reference(real_group):
    arrs, _prefix, _crc_len, _n, n_stored, t_steps = real_group
    arrs, n_out_pad = _hostile_walk_input(arrs, seed=11)
    prefix = torch.from_numpy(
        np.random.default_rng(2).integers(0, 256, idv._W, dtype=np.uint8))
    exp = _ref_walk_core(*_ref_args(arrs, prefix), n_out_pad, n_stored,
                         t_steps, True)
    got = idv._walk_core(*_port_args(arrs, prefix), n_out_pad, n_stored,
                         t_steps)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


# ---------------------------------------------------------------------------
# The scalar mirror of csrc/walk.cu (change the two together).
# ---------------------------------------------------------------------------

W_THREADS, W_UNITS = kernels.WALK_THREADS, kernels.WALK_UNITS
LL_BITS, D_BITS = kernels.WALK_LL_BITS, kernels.WALK_D_BITS
K_LEN, K_STOP, K_LONG = 1 << 21, 1 << 22, 1 << 23
K_BAD, K_DLONG = 1 << 28, 1 << 29


def _brev15_mirror(x):
    """__brev(x) >> 17: bits 0..14 of x reversed."""
    return int(f"{x & M32:032b}"[::-1], 2) >> 17


def _funnel_mirror(lo, hi, s):
    """__funnelshift_r(lo, hi, s): bits s..s+31 of hi:lo (s <= 31)."""
    return (((hi << 32) | lo) >> s) & M32


def _ll_entry_mirror(sym, nb):
    """off2 = nb + lext | nb << 5 | lext << 9 | value << 12 | flags."""
    if sym < 256:
        return nb | (nb << 5) | (sym << 12)
    if sym == 256 or sym > 285:
        return K_STOP
    lc = sym - 257
    le = max((lc >> 2) - 1, 0)
    lext = 0 if lc < 4 or lc >= 28 else le
    lbase = 258 if lc >= 28 else (
        lc + 3 if lc < 4 else 3 + ((4 + (lc & 3)) << le))
    return (nb + lext) | (nb << 5) | (lext << 9) | (lbase << 12) | K_LEN


def _d_entry_mirror(dsym, dnb):
    """dnb + dext | dnb << 5 | dext << 9 | dbase << 13, or K_BAD."""
    if dsym >= 30:
        return K_BAD
    de = max((dsym >> 1) - 1, 0)
    dext = 0 if dsym < 4 else de
    dbase = dsym + 1 if dsym < 4 else 1 + ((2 + (dsym & 1)) << de)
    return (dnb + dext) | (dnb << 5) | (dext << 9) | (dbase << 13)


def _ladder_mirror(win, rows, is_ll):
    """The long path: the compare ladder, as an entry."""
    hi, fsh, off, sym = rows
    v = _brev15_mirror(win)
    ln = 1 + sum(1 for L in range(1, 16) if v >= hi[L])
    if ln > 15:
        return K_STOP if is_ll else K_BAD
    nsym = 288 if is_ll else 32
    idx = min(max(off[ln] + ((v - fsh[ln]) >> (15 - ln)), 0), nsym - 1)
    return (_ll_entry_mirror if is_ll else _d_entry_mirror)(sym[idx], ln)


def _table_mirror(rows, is_ll):
    """build_table: one tree's 2^B primary entries (K_LONG / K_DLONG:
    long), indexed by a window's first B stream bits."""
    hi, fsh, off, sym = rows
    bits = LL_BITS if is_ll else D_BITS
    nsym = 288 if is_ll else 32
    ok = all(hi[L] >= hi[L - 1] for L in range(2, 16)) and all(
        (hi[L] & ((1 << (15 - L)) - 1)) == 0
        and (fsh[L] & ((1 << (15 - L)) - 1)) == 0
        for L in range(1, bits + 1))
    tab = []
    for t in range(1 << bits):
        v = _brev15_mirror(t)
        e = K_LONG if is_ll else K_DLONG
        if ok and v < hi[bits]:
            ln = 1 + sum(1 for L in range(1, bits) if v >= hi[L])
            idx = min(max(off[ln] + ((v - fsh[ln]) >> (15 - ln)), 0),
                      nsym - 1)
            e = (_ll_entry_mirror if is_ll else _d_entry_mirror)(sym[idx],
                                                                 ln)
        tab.append(e)
    return tab


def _walk_mirror(words, ll, d, lanes, packed, t_steps):
    """csrc/walk.cu in scalar Python, in its order. Per block of
    WALK_THREADS lanes: the live lanes' clipped unit ids, tables for the
    units [umin, umin + min(umax - umin + 1, WALK_UNITS)). Per lane: the
    register words c0..c2 at wi = min(p >> 5, nw - 3) and f3, f4 after
    them, s = p & 31, room = nw - 3 - wi. Per step: the window (lo, hi);
    the litlen entry from the table (K_LONG for a lane whose unit has no
    table) and the distance entry at its bit offset, for every lane; one
    rare path for a long entry, EOB or an invalid symbol (the ladder,
    stop); the emit and both advances selected by islen; then the words
    shifted by min(adv >> 5, room), with f3 and f4 reloaded."""
    words = [int(w) for w in np.asarray(words).view(np.uint32)]
    nw = len(words)
    ll = [np.asarray(t).tolist() for t in ll]
    d = [np.asarray(t).tolist() for t in d]
    bit, outp, uid_in, valid = (np.asarray(t).tolist() for t in lanes)
    out = np.asarray(packed, np.int64).copy()
    n_out_pad = len(out)
    n_units = len(ll[0])
    top = nw - 1
    tables = {}  # a unit's tables: the same in every block that builds them
    for b0 in range(0, len(bit), W_THREADS):
        live = [j for j in range(b0, min(b0 + W_THREADS, len(bit)))
                if valid[j] != 0]
        if not live:
            continue
        uids = {j: min(max(uid_in[j], 0), n_units - 1) for j in live}
        umin = min(uids.values())
        nu = min(max(uids.values()) - umin + 1, W_UNITS)
        for u in range(umin, umin + nu):
            if u not in tables:
                tables[u] = (_table_mirror([t[u] for t in ll], True),
                             _table_mirror([t[u] for t in d], False))
        for j in live:
            uid = uids[j]
            lrows = [t[uid] for t in ll]
            drows = [t[uid] for t in d]
            lt, dt = tables[uid] if uid - umin < nu else (None, None)
            p, o = bit[j], outp[j]
            wi = min(p >> 5, nw - 3)
            room, s = nw - 3 - wi, p & 31
            c0, c1, c2 = words[wi], words[wi + 1], words[wi + 2]
            f3, f4 = words[min(wi + 3, top)], words[min(wi + 4, top)]
            for _ in range(t_steps):
                lo = _funnel_mirror(c0, c1, s)
                hi = _funnel_mirror(c1, c2, s)
                e = lt[lo & ((1 << LL_BITS) - 1)] if lt else K_LONG
                dwin = _funnel_mirror(lo, hi, e & 31)
                de = dt[dwin & ((1 << D_BITS) - 1)] if dt else K_DLONG
                if e & (K_STOP | K_LONG) or (e & K_LEN
                                             and de & (K_BAD | K_DLONG)):
                    if e & K_LONG:
                        e = _ladder_mirror(lo, lrows, True)
                    if e & K_STOP:
                        break
                    if e & K_LEN:
                        dwin = _funnel_mirror(lo, hi, e & 31)
                        if dt:
                            de = dt[dwin & ((1 << D_BITS) - 1)]
                        if de & K_DLONG:
                            de = _ladder_mirror(dwin, drows, False)
                        if de & K_BAD:
                            break
                islen = bool(e & K_LEN)
                off2, nb, lext = e & 31, (e >> 5) & 15, (e >> 9) & 7
                val = (e >> 12) & 511
                dnb, dext = (de >> 5) & 15, (de >> 9) & 15
                mext = _funnel_mirror(lo, hi, nb) & ((1 << lext) - 1)
                dx = ((((hi << 32) | lo) >> (off2 + dnb))
                      & ((1 << dext) - 1))
                mdist = ((de >> 13) & 0x7FFF) + dx
                pk = (mdist << 9) | 1 if islen else (val << 1) | 1
                if o < n_out_pad:
                    out[o] = max(out[o], pk)
                o += val + mext if islen else 1
                adv = s + (off2 + (de & 31) if islen else nb)
                delta = min(adv >> 5, room)
                s, room, wi = adv & 31, room - delta, wi + delta
                c0, c1, c2 = ((c0, c1, c2), (c1, c2, f3), (c2, f3, f4))[delta]
                f3, f4 = words[min(wi + 3, top)], words[min(wi + 4, top)]
    return out


def _walk_kernel_args(arrs, n_out_pad, n_stored, prefix):
    ll = (*canon._canon_unit_tables(arrs["ll_first"], arrs["ll_cnt"],
                                    arrs["ll_off"]), arrs["ll_sym"])
    d = (*canon._canon_unit_tables(arrs["d_first"], arrs["d_cnt"],
                                   arrs["d_off"]), arrs["d_sym"])
    lanes = tuple(arrs[k] for k in ("lane_bit", "lane_out", "lane_uid",
                                    "lane_valid"))
    litval, start_mark, dist_at = idv._stage_out(
        prefix, arrs["sr"], arrs["words"], n_out_pad, n_stored)
    packed = torch.where(start_mark >= 0,
                         (dist_at << 9) | (litval << 1) | 1, 0).int()
    return arrs["words"], ll, d, lanes, packed


def _hostile_trees(words, ll, d, lanes, packed, seed):
    """The real tables plus idv._with_edge_units' two (the reserved
    litlen symbols 286/287, windows past the tree, distances 30 and 31),
    seeded words (half real code), and lanes at random bits, a fifth of
    them past the body's last word."""
    rng = np.random.default_rng(seed)
    ll, d = idv._with_edge_units(ll, d)
    nw = words.shape[0]
    w = rng.integers(0, 1 << 32, nw, dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    w[: nw // 2] = words.numpy()[: nw // 2]
    n = 300
    u = ll[0].shape[0]
    npad = packed.shape[0]
    far = rng.random(n) < 0.2
    lanes = tuple(torch.from_numpy(x.astype(np.int32)) for x in (
        np.where(far, rng.integers(32 * nw - 40, 32 * nw + 4000, n),
                 rng.integers(0, 32 * nw, n)),
        rng.integers(0, npad, n),
        np.where(rng.random(n) < 0.6, rng.integers(u - 2, u, n),
                 rng.integers(-2, u + 3, n)),
        rng.random(n) < 0.9))
    return torch.from_numpy(w.copy()), ll, d, lanes, packed


@pytest.mark.parametrize("kind", ["real", "hostile", "hostile_trees"])
def test_walk_mirror_matches_plain(real_group, kind):
    arrs, prefix, _crc_len, n_out_pad, n_stored, t_steps = real_group
    if kind == "hostile":
        arrs, n_out_pad = _hostile_walk_input(arrs, seed=12)
    words, ll, d, lanes, packed = _walk_kernel_args(arrs, n_out_pad,
                                                    n_stored, prefix)
    if kind == "hostile_trees":
        words, ll, d, lanes, packed = _hostile_trees(words, ll, d, lanes,
                                                     packed, seed=13)
    before = kernels.launches["anchor_walk"]
    got = kernels.anchor_walk(words, ll, d, lanes, packed.clone(), t_steps)
    assert kernels.launches["anchor_walk"] == before  # CPU: plain version
    plain = kernels.anchor_walk_plain(words, ll, d, lanes, packed.clone(),
                                      t_steps)
    mirror = _walk_mirror(words, ll, d, lanes, packed.numpy(), t_steps)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(mirror, plain.numpy())
    assert (plain.numpy() != packed.numpy()).any()


def _entries_from_plain(sym, ln, valid, is_ll):
    """The entry each window must decode to, from the plain version's
    symbol decode (numpy over all windows)."""
    sym, ln, valid = (np.asarray(x, np.int64) for x in (sym, ln, valid))
    if is_ll:
        lc = np.clip(sym - 257, 0, 28)
        le = np.maximum((lc >> 2) - 1, 0)
        lext = np.where((lc < 4) | (lc >= 28), 0, le)
        lbase = np.where(lc >= 28, 258,
                         np.where(lc < 4, lc + 3, 3 + ((4 + (lc & 3)) << le)))
        e = np.where(sym < 256, ln | (ln << 5) | (sym << 12),
                     (ln + lext) | (ln << 5) | (lext << 9) | (lbase << 12)
                     | K_LEN)
        stop = ~valid.astype(bool) | (sym == 256) | (sym > 285)
        return np.where(stop, K_STOP, e)
    ds = np.clip(sym, 0, 29)
    de = np.maximum((ds >> 1) - 1, 0)
    dext = np.where(ds < 4, 0, de)
    dbase = np.where(ds < 4, ds + 1, 1 + ((2 + (ds & 1)) << de))
    e = (ln + dext) | (ln << 5) | (dext << 9) | (dbase << 13)
    return np.where(~valid.astype(bool) | (sym >= 30), K_BAD, e)


def test_walk_table_equals_ladder_on_every_window(real_group):
    """The mirrored primary table of each unit of the real group, against
    the plain version's compare ladder on every 15-bit window: a fast
    entry decodes its window exactly, and an entry is long exactly where
    the code is longer than B bits or the window lies past the tree."""
    arrs, prefix, _c, n_out_pad, n_stored, _t = real_group
    _w, ll, d, _lanes, _p = _walk_kernel_args(arrs, n_out_pad, n_stored,
                                              prefix)
    wins = np.arange(1 << 15)
    v = torch.from_numpy(idv._brev15()[wins]).long()
    units = int(arrs["unit_valid"].sum())
    assert units >= 2
    for u in range(units):
        for rows, is_ll in ((ll, True), (d, False)):
            nsym = 288 if is_ll else 32
            tables = tuple(t[u : u + 1].expand(len(wins), -1).long()
                           for t in rows[:3])
            sym, ln, valid = canon._canon_symbol(
                v, *tables, rows[3].long().reshape(-1),
                torch.full((len(wins),), u), nsym)
            want = _entries_from_plain(sym.numpy(), ln.numpy(),
                                       valid.numpy(), is_ll)
            tab = np.array(_table_mirror([t[u].tolist() for t in rows],
                                         is_ll))
            bits = LL_BITS if is_ll else D_BITS
            got = tab[wins & ((1 << bits) - 1)]
            fast = got != (K_LONG if is_ll else K_DLONG)
            np.testing.assert_array_equal(got[fast], want[fast])
            long_ = (ln.numpy() > bits) | ~valid.numpy()
            np.testing.assert_array_equal(~fast, long_)
            assert fast.mean() > 0.5
            ladder = [_ladder_mirror(int(w), [t[u].tolist() for t in rows],
                                     is_ll) for w in wins[::97]]
            np.testing.assert_array_equal(ladder, want[::97])


def test_sorted_padded_lanes_walk_like_unpadded():
    """Shuffled lanes and the same lanes planned by _walk_lanes (sorted
    by (uid, bit), each unit's run padded with invalid lanes) give the
    unpadded lanes' packed, in the plain version and in the mirror (whose
    blocks of shuffled lanes span more units than a block holds: those
    lanes take the ladder). One group of 15 chunks of 4 KiB."""
    data = INDEXED["defer"]()
    mp = pytest.MonkeyPatch()
    try:
        out, calls = _capture_port(mp, _indexed(data))
    finally:
        mp.undo()
    assert out == data and len(calls) == 1
    arrs, prefix, _c, n_out_pad, n_stored, t_steps = calls[0]
    words, ll, d, lanes, packed = _walk_kernel_args(arrs, n_out_pad,
                                                    n_stored, prefix)
    live = lanes[3].numpy() != 0
    bit, out, uid = (t.numpy()[live] for t in lanes[:3])
    assert len(np.unique(uid)) > W_UNITS  # the plan has runs to pad
    perm = np.random.default_rng(5).permutation(len(bit))
    shuffled = tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        bit[perm], out[perm], uid[perm], np.ones(len(bit), np.int32)))
    planned = idv._walk_lanes(bit[perm], out[perm], uid[perm])
    assert planned.shape[1] % (W_THREADS // W_UNITS) == 0
    ok = planned[3] != 0
    assert sorted(zip(*planned[:3, ok].tolist())) == sorted(
        zip(bit.tolist(), out.tolist(), uid.tolist()))
    for b0 in range(0, planned.shape[1], W_THREADS):
        blk = slice(b0, b0 + W_THREADS)
        assert len(np.unique(planned[2, blk][planned[3, blk] != 0])) \
            <= W_UNITS
    planned = tuple(torch.from_numpy(np.ascontiguousarray(x))
                    for x in planned)
    exp = kernels.anchor_walk_plain(words, ll, d, lanes, packed.clone(),
                                    t_steps).numpy()
    for ln in (shuffled, planned):
        got = kernels.anchor_walk_plain(words, ll, d, ln, packed.clone(),
                                        t_steps)
        np.testing.assert_array_equal(got.numpy(), exp)
        mirror = _walk_mirror(words, ll, d, ln, packed.numpy(), t_steps)
        np.testing.assert_array_equal(mirror, exp)


def test_walk_constants_match_kernels_header():
    """ops/kernels' launch shape equals csrc/kernels.h's #defines."""
    import re
    from pathlib import Path

    src = (Path(kernels.__file__).resolve().parent.parent / "csrc"
           / "kernels.h").read_text()
    defs = dict(re.findall(r"#define (ZZ_WALK_\w+) (\d+)\n", src))
    assert {k: int(v) for k, v in defs.items()} == {
        "ZZ_WALK_THREADS": kernels.WALK_THREADS,
        "ZZ_WALK_UNITS": kernels.WALK_UNITS,
        "ZZ_WALK_LL_BITS": kernels.WALK_LL_BITS,
        "ZZ_WALK_D_BITS": kernels.WALK_D_BITS}
    assert kernels.WALK_SMEM_BYTES == 21824
    assert "ZZ_WALK_SMEM_BYTES" in src and "(1 << ZZ_WALK_LL_BITS)" in src


def test_anchor_walk_rejects_bad_arguments(real_group):
    arrs, prefix, _c, n_out_pad, n_stored, t_steps = real_group
    words, ll, d, lanes, packed = _walk_kernel_args(arrs, n_out_pad,
                                                    n_stored, prefix)
    with pytest.raises(TypeError):
        kernels.anchor_walk(words.long(), ll, d, lanes, packed, t_steps)
    with pytest.raises(ValueError):
        kernels.anchor_walk(words, ll, d, lanes[:3] + (lanes[3][:-1],),
                            packed, t_steps)
    with pytest.raises(ValueError):
        kernels.anchor_walk(words, ll[:3] + (d[3],), d, lanes, packed,
                            t_steps)


# ---------------------------------------------------------------------------
# Host plan and every group's staged inputs.
# ---------------------------------------------------------------------------


def test_plan_units_match_reference(streams):
    for name in ("mixed_stored_and_coded", "walk_nolut_mixed", "grouped"):
        data, blob = streams[name]
        header_len, cb, _t, chunks = containers.parse_gzip_index(blob)
        body = blob[header_len:-8]
        starts = [idv._W + i * cb for i in range(len(chunks))]
        sizes = [min(cb, max(0, len(data) - i * cb))
                 for i in range(len(chunks))]
        bits, outs, ll, d, runs, ranges = idv._plan_units(body, chunks,
                                                          starts, sizes)
        units, e_runs, e_ranges = ref._plan_units(body, chunks, starts, sizes)
        assert runs.tolist() == [list(r) for r in e_runs]
        assert ranges.tolist() == [list(r) for r in e_ranges]
        assert len(bits) == len(outs) == len(units) > 0
        assert bits.tolist() == [u.bit for u in units]
        assert outs.tolist() == [u.out_base for u in units]
        for k in range(4):
            np.testing.assert_array_equal(
                ll[k], np.stack([u.ll[k] for u in units]))
            np.testing.assert_array_equal(
                d[k], np.stack([u.d[k] for u in units]))


@pytest.mark.parametrize("name", ["grouped", "anchor_long_blocks"])
def test_group_inputs_match_reference(streams, monkeypatch, name):
    """The lanes, words, tables and stored runs of every group, against
    what the reference hands its _walk_all (multi-group with
    _WGROUP_OUT = 32 KiB in both packages). The port's lanes are the
    reference's, planned by _walk_lanes: sorted by (uid, bit), each
    unit's run padded with invalid lanes, then zeros."""
    data, blob = streams[name]
    if name == "grouped":
        monkeypatch.setattr(ref, "_WGROUP_OUT", 1 << 15)
        monkeypatch.setattr(idv, "_WGROUP_OUT", 1 << 15)
    seen = []

    def rec(*args, **kw):
        seen.append([np.asarray(a) for a in args[:16]] + [kw])
        return jnp.zeros((kw["n_out_pad"],), jnp.uint8), jnp.uint32(0)

    monkeypatch.setattr(ref, "_walk_all", rec)
    ref.decompress_indexed(blob, verify=False)
    out, calls = _capture_port(monkeypatch, blob)
    assert out == data
    assert len(calls) == len(seen) >= (2 if name == "grouped" else 1)
    for (arrs, _p, crc_len, n_out_pad, n_stored, t_steps), e in zip(calls,
                                                                    seen):
        for k, ea in zip(_WALK_KEYS[:9], e):
            ga = arrs[k].numpy()
            if k == "words":
                ga = ga.view(np.uint32)
            np.testing.assert_array_equal(ga, ea.astype(ga.dtype))
        live = e[12].astype(bool)
        want = idv._walk_lanes(*(x[live] for x in e[9:12]))
        got = np.stack([arrs[k].numpy() for k in _WALK_KEYS[9:]])
        np.testing.assert_array_equal(got[:, : want.shape[1]], want)
        assert not got[:, want.shape[1] :].any()
        np.testing.assert_array_equal(arrs["sr"].numpy(), e[14])
        assert crc_len == int(e[15])
        kw = e[16]
        assert (n_out_pad, n_stored, t_steps) == (
            kw["n_out_pad"], kw["n_stored"], kw["t_steps"])


def _recorded_partitions(monkeypatch):
    """The groups _partition returns, one list a call."""
    seen = []
    orig = idv._partition

    def rec(*args):
        seen.append(orig(*args))
        return seen[-1]

    monkeypatch.setattr(idv, "_partition", rec)
    return seen


def _greedy(n, opens):
    """[lo, hi) groups: item i > lo opens a new group when opens(lo, i)."""
    groups, lo = [], 0
    for i in range(n):
        if i > lo and opens(lo, i):
            groups.append((lo, i))
            lo = i
    return groups + [(lo, n)] if lo < n else groups


def test_partition_gives_both_entries_groups(streams, mixed, monkeypatch):
    """One partition serves both entries: the indexed rule counts
    chunk_bytes of output a chunk, the foreign rule floors bit ends to
    bytes. Each entry's groups, on a multi-group stream, are those rules'
    (shrunk walk groups), and the bytes decode."""
    seen = _recorded_partitions(monkeypatch)
    monkeypatch.setattr(idv, "_WGROUP_OUT", 1 << 15)
    data, blob = streams["grouped"]
    assert idv.decompress_indexed(blob, device="cpu") == data
    _h, cb, _t, chunks = containers.parse_gzip_index(blob)
    cpos = np.r_[0, np.cumsum([sz for sz, _b, _a in chunks])]
    out_cap = max(idv._WGROUP_OUT, cb)
    want = _greedy(len(chunks), lambda lo, i: (
        cpos[i + 1] - cpos[lo] > idv._WGROUP_BODY
        or (i + 1 - lo) * cb > out_cap))
    assert seen == [want] and len(want) >= 2

    seen.clear()
    monkeypatch.setattr(idv, "_WGROUP_OUT", 1 << 17)
    monkeypatch.setattr(idv, "_WGROUP_BODY", 1 << 16)
    blob = gzip.compress(mixed, 6, mtime=0)
    assert idv.decompress_foreign(blob, format="gzip", device="cpu") == mixed
    body = blob[containers.parse_gzip_header(blob):]
    blocks, _anc, total, end_bit = native.scan_anchors(
        body, idv.FOREIGN_ANCHOR_TOKENS)
    bit_ends = np.r_[blocks[1:, 0], end_bit]
    out_ends = np.r_[blocks[1:, 2], total]
    want = _greedy(len(blocks), lambda lo, i: (
        bit_ends[i] // 8 - blocks[lo, 0] // 8 > idv._WGROUP_BODY
        or out_ends[i] - blocks[lo, 2] > idv._WGROUP_OUT))
    assert seen == [want] and len(want) >= 2


@pytest.mark.parametrize("in_order", [True, False])
def test_lanes_attach_anchors_within_their_item(in_order):
    """Each anchor walks with the unit that np.searchsorted finds among
    its own item's units as recorded (the last at or before it); anchors
    before every unit of their item, or in an item without units (a
    stored chunk), are dropped. Block records out of bit order, as a
    crafted index may give them, are searched item by item as before."""
    ranges = np.array([[0, 3], [3, 3], [3, 5], [5, 6]])  # item 1: stored
    bits = np.array([100, 400, 900, 2000, 2600, 4000])
    if not in_order:
        bits[[0, 2]] = bits[[2, 0]]
    outs = bits * 3 + 7
    rng = np.random.default_rng(1)
    item = np.repeat(np.arange(4), [9, 4, 7, 5])
    lo = np.array([50, 1000, 1900, 3900])[item]
    abit = lo + rng.integers(0, 1000, len(item))
    order = np.lexsort((abit, item))
    anchors = np.stack([abit[order], abit[order] * 5 + 1, item[order]])
    want = [bits, outs, np.arange(len(bits))]
    for i, (ulo, uhi) in enumerate(ranges):
        a = anchors[:, anchors[2] == i]
        if ulo == uhi:
            continue
        k = np.searchsorted(bits[ulo:uhi], a[0], side="right") - 1
        ok = k >= 0
        want = [np.r_[w, x] for w, x in zip(want, (a[0, ok], a[1, ok],
                                                   ulo + k[ok]))]
    assert len(want[0]) < len(bits) + len(item)  # some anchors dropped
    np.testing.assert_array_equal(idv._lanes(bits, outs, ranges, anchors),
                                  idv._walk_lanes(*want))


# ---------------------------------------------------------------------------
# The per-bit path of v2 indexes.
# ---------------------------------------------------------------------------


def test_v2_decode_bits_and_commit_walk_match_reference(streams,
                                                        monkeypatch):
    data, blob = streams["text_multichunk"]
    seen = []
    orig = idv._decode_all

    def rec(*args):
        seen.append(args)
        return orig(*args)

    monkeypatch.setattr(idv, "_decode_all", rec)
    assert idv.decompress_indexed(_v2(blob), device="cpu") == data
    (words, llf, llc, llo, lls, df, dc, do, ds, start_bits, _ob, uvalid,
     _prefix, _sr, nbits, _n, max_sup_span, _ns) = seen[0]
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    ll_lut = idv._build_luts(llf, llc, llo, lls, idv._ll_attr(), 288, 10)
    d_lut = idv._build_luts(df, dc, do, ds, idv._d_attr(), 32, 5)
    e_ll = ref._build_luts(j(llf), j(llc), j(llo), j(lls),
                           jnp.asarray(ref._ll_attr()), 288, 10)
    e_d = ref._build_luts(j(df), j(dc), j(do), j(ds),
                          jnp.asarray(ref._d_attr()), 32, 5)
    np.testing.assert_array_equal(ll_lut.numpy(), np.asarray(e_ll))
    np.testing.assert_array_equal(d_lut.numpy(), np.asarray(e_d))
    lo, hi = idv._bit_windows(words)
    e_lo, e_hi = ref._bit_windows(jnp.asarray(words.numpy().view(np.uint32)))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(e_lo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(e_hi))
    # Owning unit of every bit, as _decode_all derives it.
    sb = start_bits.numpy()
    uid = np.zeros(nbits, np.int64)
    for u, b in enumerate(sb):
        if uvalid[u]:
            uid[b] = max(uid[b], u)
    uid = np.maximum.accumulate(uid)
    got = idv._decode_bits(lo, hi, torch.from_numpy(uid), ll_lut, d_lut)
    exp = ref._decode_bits(e_lo, e_hi, jnp.asarray(uid.astype(np.int32)),
                           e_ll, e_d)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    committed = idv._commit_walk(got[0], start_bits, uvalid, max_sup_span)
    e_commit = jax.jit(ref._commit_walk, static_argnums=3)(
        exp[0], jnp.asarray(sb), jnp.asarray(uvalid.numpy()), max_sup_span)
    np.testing.assert_array_equal(committed.numpy(), np.asarray(e_commit))
    assert committed.numpy().sum() > 100  # every token of the group


# ---------------------------------------------------------------------------
# Whole calls against the reference.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(INDEXED) + [
    "level1", "level6", "level9", "multi_subblock", "boundary_crossing",
    "anchor_long_blocks"])
def test_decompress_indexed_matches_reference(streams, name):
    data, blob = streams[name]
    got = _outcome(lambda: idv.decompress_indexed(blob, device="cpu"))
    exp = _outcome(lambda: ref.decompress_indexed(blob, verify=False))
    assert got == exp == data


def test_indexed_to_device_and_grouped_seams(streams, monkeypatch):
    monkeypatch.setattr(ref, "_WGROUP_OUT", 1 << 15)
    monkeypatch.setattr(idv, "_WGROUP_OUT", 1 << 15)
    data, blob = streams["grouped"]
    got = idv.decompress_indexed(blob, device="cpu")
    assert got == ref.decompress_indexed(blob, verify=False) == data
    arr, n = idv.decompress_indexed(blob, device="cpu", to_device=True)
    assert arr.dtype == torch.uint8 and arr.device.type == "cpu"
    assert n == len(data) and bytes(arr.numpy()) == data
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x40  # a payload byte: the CRC catches it
    with pytest.raises(ValueError):
        idv.decompress_indexed(bytes(bad), device="cpu")
    data, blob = streams["anchor_long_blocks"]
    arr, n = idv.decompress_indexed(blob, device="cpu", to_device=True)
    assert n == len(data) and bytes(arr.numpy()) == data


def test_indexed_none_and_corrupt_cases(streams):
    # Unindexed: None in both.
    blob = zt.compress(b"plain stream " * 100, level=6, format="gzip",
                       chunk_bytes=CHUNK, device="cpu")
    assert idv.decompress_indexed(blob, device="cpu") is None
    assert ref.decompress_indexed(blob) is None
    # A corrupt index (an oversized block count): None in both.
    data = b"bounds checked " * 500
    bad = bytearray(_indexed(data))
    bad[16 + 12 + 4 : 16 + 12 + 6] = (0xFFFF).to_bytes(2, "little")
    assert idv.decompress_indexed(bytes(bad), device="cpu") is None
    assert ref.decompress_indexed(bytes(bad)) is None
    # An index longer than the buffer: None in both.
    _d, blob = streams["text_multichunk"]
    assert idv.decompress_indexed(blob[:-100], device="cpu") is None
    assert ref.decompress_indexed(blob[:-100]) is None
    # A flipped CRC bit: both raise (the reference with its own CRC).
    data = b"crc guarded " * 1000
    bad = bytearray(_indexed(data))
    bad[-5] ^= 0x01
    assert _outcome(lambda: idv.decompress_indexed(bytes(bad),
                                                   device="cpu")) == "ValueError"
    assert _outcome(lambda: ref.decompress_indexed(bytes(bad))) == "ValueError"
    # A hostile chunk_bytes: both raise.
    hdr_len, cb, t, chunks = containers.parse_gzip_index(bytes(bad))
    hostile = (containers.gzip_header_indexed(512, chunks)
               + bytes(bad)[hdr_len:])
    assert _outcome(lambda: idv.decompress_indexed(hostile, device="cpu")) \
        == _outcome(lambda: ref.decompress_indexed(hostile)) == "ValueError"


def test_v2_index_decodes_like_reference(streams):
    data, blob = streams["text_multichunk"]
    v2 = _v2(blob)
    assert containers.parse_gzip_index(v2)[2] == 0
    got = idv.decompress_indexed(v2, device="cpu")
    assert got == ref.decompress_indexed(v2, verify=False) == data


def test_multimember_public_route(streams):
    a = b"indexed member payload " * 800
    b = b"appended plain member " * 300
    blob = _indexed(a) + zlib.compress(b, 6, wbits=31)
    assert gzip.decompress(blob) == a + b
    assert idv.decompress_indexed(blob, device="cpu") == a + b
    with pytest.raises(ValueError):
        idv.decompress_indexed(blob, device="cpu", to_device=True)
    got = zt.decompress(blob, format="gzip", engine="device", device="cpu")
    assert got == zf.decompress(blob, format="gzip", engine="tpu") == a + b


# ---------------------------------------------------------------------------
# Foreign streams.
# ---------------------------------------------------------------------------


def _raw(data, level=6):
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    return c.compress(data) + c.flush()


def _strategy(data, strat):
    c = zlib.compressobj(6, zlib.DEFLATED, 15, 8, strat)
    return c.compress(data) + c.flush()


FOREIGN = {
    "zlib1": ("zlib", lambda m: zlib.compress(m, 1)),
    "zlib6": ("zlib", lambda m: zlib.compress(m, 6)),
    "zlib9": ("zlib", lambda m: zlib.compress(m, 9)),
    "gzip6": ("gzip", lambda m: gzip.compress(m, 6, mtime=0)),
    "raw6": ("raw", _raw),
    "fixed": ("zlib", lambda m: _strategy(m[: 1 << 17], zlib.Z_FIXED)),
    "rle": ("zlib", lambda m: _strategy(m[: 1 << 17], zlib.Z_RLE)),
    "filtered": ("zlib", lambda m: _strategy(m[: 1 << 17], zlib.Z_FILTERED)),
    "trailing_junk": ("zlib", lambda m: zlib.compress(m[: 1 << 17], 6) + b"XX"),
}


@pytest.mark.parametrize("name", list(FOREIGN))
def test_decompress_foreign_matches_reference(mixed, name):
    fmt, make = FOREIGN[name]
    blob = make(mixed)
    got = _outcome(lambda: idv.decompress_foreign(blob, format=fmt,
                                                  device="cpu"))
    exp = _outcome(lambda: ref.decompress_foreign(blob, format=fmt,
                                                  verify=False))
    want = mixed if name in ("zlib1", "zlib6", "zlib9", "gzip6",
                             "raw6") else mixed[: 1 << 17]
    assert got == exp == want


@pytest.mark.parametrize("name", list(FOREIGN))
def test_foreign_spacing_keeps_walk_arrays(mixed, monkeypatch, name):
    """decompress_foreign at FOREIGN_ANCHOR_TOKENS (shorter lanes) gives
    every group's _walk_core arrays as at C.ANCHOR_TOKENS, and the
    reference's bytes."""
    fmt, make = FOREIGN[name]
    blob = make(mixed)
    orig = idv._walk_core
    runs = {}
    assert idv.FOREIGN_ANCHOR_TOKENS < ANCHOR_TOKENS
    for spacing in (idv.FOREIGN_ANCHOR_TOKENS, ANCHOR_TOKENS):
        seen = []

        def rec(*args):
            seen.append((args[12].sum().item(), args[-1],
                         [t.clone() for t in orig(*args)]))
            return tuple(t.clone() for t in seen[-1][2])

        monkeypatch.setattr(idv, "_walk_core", rec)
        monkeypatch.setattr(idv, "FOREIGN_ANCHOR_TOKENS", spacing)
        runs[spacing] = (idv.decompress_foreign(blob, format=fmt,
                                                device="cpu"), seen)
    monkeypatch.setattr(idv, "_walk_core", orig)
    (fine, fine_walks), (coarse, coarse_walks) = runs.values()
    assert fine == coarse == ref.decompress_foreign(blob, format=fmt,
                                                    verify=False)
    assert len(fine_walks) == len(coarse_walks) >= 1
    for (nf, tf, af), (nc, tc, ac) in zip(fine_walks, coarse_walks):
        assert nf > nc and tf < tc  # more, shorter lanes
        for g, e in zip(af, ac):
            np.testing.assert_array_equal(g.numpy(), e.numpy())


def test_foreign_none_corrupt_multimember_and_to_device(mixed):
    rnd = np.random.default_rng(0).integers(0, 256, 1 << 16,
                                            dtype=np.uint8).tobytes()
    z = zlib.compress(rnd, 0)  # all stored: None in both
    assert idv.decompress_foreign(z, format="zlib", device="cpu") is None
    assert ref.decompress_foreign(z, format="zlib") is None
    zd = zlib.compressobj(6, zlib.DEFLATED, 15, 8, 0, zdict=b"dictionary")
    zd = zd.compress(b"dictionary text " * 50) + zd.flush()
    assert idv.decompress_foreign(zd, format="zlib", device="cpu") is None
    assert ref.decompress_foreign(zd, format="zlib") is None
    # Corrupt per the scanner: None in both (the host decoder raises).
    junk = b"\x78\x9c" + b"\xff" * 64
    assert idv.decompress_foreign(junk, format="zlib", device="cpu") is None
    assert ref.decompress_foreign(junk, format="zlib") is None
    # A flipped CRC byte: the port raises on its device CRC; the
    # reference's bytes are the input, so its CRC (held equal to the
    # port's above) fails the same way.
    g = bytearray(gzip.compress(mixed[: 1 << 17], 6, mtime=0))
    g[-5] ^= 0xFF
    assert _outcome(lambda: idv.decompress_foreign(
        bytes(g), format="gzip", device="cpu")) == "ValueError"
    assert ref.decompress_foreign(bytes(g), format="gzip",
                                  verify=False) == mixed[: 1 << 17]
    # A flipped Adler byte: both raise (checked on the host).
    z = bytearray(zlib.compress(mixed[: 1 << 17], 6))
    z[-1] ^= 0x01
    assert _outcome(lambda: idv.decompress_foreign(
        bytes(z), format="zlib", device="cpu")) \
        == _outcome(lambda: ref.decompress_foreign(bytes(z), format="zlib")) \
        == "ValueError"
    # Two members: both on the device (the reference decodes the second
    # on the host).
    a, b = mixed[: 1 << 17], mixed[1 << 17 : 1 << 18]
    two = gzip.compress(a, 6, mtime=0) + gzip.compress(b, 5, mtime=0)
    assert idv.decompress_foreign(two, format="gzip", device="cpu") == a + b
    assert ref.decompress_foreign(two, format="gzip", verify=False) == a + b
    arr, n = idv.decompress_foreign(gzip.compress(a, 6, mtime=0),
                                    format="gzip", device="cpu",
                                    to_device=True)
    assert n == len(a) and bytes(arr.numpy()) == a


# ---------------------------------------------------------------------------
# Public routes.
# ---------------------------------------------------------------------------


def test_public_decompress_routes(mixed):
    a = mixed[: 1 << 17]
    for blob, fmt in ((zlib.compress(a, 7), "zlib"), (_raw(a, 4), "raw")):
        got = zt.decompress(blob, format=fmt, engine="device", device="cpu")
        assert got == zf.decompress(blob, format=fmt, engine="tpu") == a
    # Streams the device path declines go to the host decoder.
    rnd = np.random.default_rng(0).integers(0, 256, 1 << 16,
                                            dtype=np.uint8).tobytes()
    z = zlib.compress(rnd, 0)
    assert zt.decompress(z, format="zlib", engine="device",
                         device="cpu") == rnd
    zdict = b"preset dictionary words " * 8
    c = zlib.compressobj(6, zlib.DEFLATED, 15, 8, 0, zdict=zdict)
    zd = c.compress(a[:5000]) + c.flush()
    assert zt.decompress(zd, format="zlib", dictionary=zdict,
                         engine="device", device="cpu") == a[:5000]
    assert zf.decompress(zd, format="zlib", dictionary=zdict,
                         engine="tpu") == a[:5000]
    # An unindexed gzip stream with a broken index goes to the foreign
    # walk; engine="native" never touches the device path.
    data = b"bounds checked " * 500
    bad = bytearray(_indexed(data))
    bad[16 + 12 + 4 : 16 + 12 + 6] = (0xFFFF).to_bytes(2, "little")
    assert zt.decompress(bytes(bad), format="gzip", engine="device",
                         device="cpu") == data
    assert zt.decompress(bytes(bad), format="gzip") == data
    with pytest.raises(ValueError):
        zt.decompress(z, format="zlib", engine="tpu")


def test_device_engine_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    blob = zlib.compress(b"abc" * 100)
    with pytest.raises(RuntimeError):
        zt.decompress(blob, engine="device")
    with pytest.raises(RuntimeError):
        idv.decompress_indexed(_indexed(b"abc" * 100))
    with pytest.raises(RuntimeError):
        idv.decompress_foreign(blob, format="zlib")
    assert zt.decompress(blob) == b"abc" * 100  # native needs no card

