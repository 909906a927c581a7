"""Device decode's LZ tail (ops/kernels.token_scatter and resolve_lz,
csrc/resolve.cu) against the JAX package's models/inflate_tpu.py, on the
CPU.

token_scatter: the plain torch version and ``_scatter_mirror``, a numpy
mirror of the kernel's arithmetic (per committed token of the range, three
int32 maxima, each field on its own), equal the reference's three
``.at[tgt].max(mode="drop")`` (inflate_tpu.py:623-636) on the v2 group's
arguments and on the seeded cases of utils/corpus.scatter_inputs.

resolve_lz: the plain version and ``_resolve_mirror``, a numpy mirror of
the kernel in its own order (tile maxima, the carry's exclusive prefix
maxima, each warp's runs of 32 scanned in turn, the first hop in 64-bit
arithmetic, the 40 round launches over two buffers with their flags, the
gather from buffer 0), equal the reference's jitted _resolve_parent and
_resolve_lz on a real group of each decode path and on the seeded cases
of utils/corpus.resolve_inputs. Tolerance is zero: both are integer-only.
Change the kernels and their mirrors together.
"""
import re
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import zzflate_tpu_torch as zt
from zzflate_tpu.models import inflate_tpu as ref
from zzflate_tpu_torch.models import inflate_device as idv
from zzflate_tpu_torch.ops import kernels
from zzflate_tpu_torch.utils import containers
from zzflate_tpu_torch.utils.corpus import (
    RESOLVE_CASES,
    SCATTER_CASES,
    mixed_corpus,
    resolve_inputs,
    scatter_inputs,
)

# One intra-op thread apiece: the test processes share the CPU.
torch.set_num_threads(1)

INT_MIN = -(1 << 31)
TILE = kernels.RESOLVE_TILE
WARPS = kernels.RESOLVE_THREADS // 32
STEPS = kernels.RESOLVE_STEPS
ROUNDS = kernels.RESOLVE_ROUNDS
N_HOSTILE = 1 << 21  # the hostile resolve arrays: past the 2^20 chain
SCATTER_BITS, SCATTER_OUT = 1 << 18, 1 << 17

_ref_parent = jax.jit(ref._resolve_parent, static_argnums=2)
_ref_lz = jax.jit(ref._resolve_lz, static_argnums=3)


@jax.jit
def _ref_scatter(litval, start_mark, dist_at, off, committed, islit, islen,
                 sym, mdist):
    """inflate_tpu.py:623-636, as the reference's _decode_all runs it."""
    n_out_pad = litval.shape[0]
    com_tok = committed & (islit | islen)
    tgt = jnp.where(com_tok, off, n_out_pad)
    litval = litval.at[tgt].max(jnp.where(islit, sym, 0), mode="drop")
    start_mark = start_mark.at[tgt].max(jnp.where(com_tok, off, -1),
                                        mode="drop")
    dist_at = dist_at.at[tgt].max(jnp.where(islen, mdist, 0), mode="drop")
    return litval, start_mark, dist_at


# ---------------------------------------------------------------------------
# The numpy mirrors of csrc/resolve.cu.
# ---------------------------------------------------------------------------


def _scatter_mirror(litval, start_mark, dist_at, off, committed, islit,
                    islen, sym, mdist):
    """One thread a bit: a committed token inside [0, n) makes three int32
    maxima on its slot, reading off as int64 and sym and mdist as int32
    (as decode_candidates writes them); every other bit writes nothing."""
    assert off.dtype == np.int64 and sym.dtype == mdist.dtype == np.int32
    n = litval.shape[0]
    lv, sm, da = (a.astype(np.int32).copy()
                  for a in (litval, start_mark, dist_at))
    ok = committed & (islit | islen) & (off >= 0) & (off < n)
    o = off[ok]
    np.maximum.at(lv, o, np.where(islit[ok], sym[ok], 0))
    np.maximum.at(sm, o, o.astype(np.int32))
    np.maximum.at(da, o, np.where(islen[ok], mdist[ok], 0))
    return lv, sm, da


def _resolve_mirror(litval, start_mark, dist_at):
    """(bytes, parent, rounds) by the kernel's launches, in order."""
    n = start_mark.shape[0]
    ntiles = -(-n // TILE)
    sm = np.full(ntiles * TILE, INT_MIN, np.int64)
    sm[:n] = start_mark
    # 1. tile maxima; block 0 zeroes the flags.
    tmax = sm.reshape(ntiles, TILE).max(1)
    flags = np.zeros(ROUNDS + 1, np.int64)
    # 2. carry: exclusive prefix maxima of the tiles.
    carry = np.r_[INT_MIN, np.maximum.accumulate(tmax)[:-1]]
    # 3. each warp's STEPS runs of 32 in turn, carried from run to run; the
    #    warps' totals and the tile's carry joined before the hop.
    runs = np.maximum.accumulate(sm.reshape(ntiles, WARPS, STEPS * 32), 2)
    wtot = runs[:, :, -1]
    before = np.maximum.accumulate(
        np.concatenate([carry[:, None], wtot[:, :-1]], 1), 1)
    seg = np.maximum(runs, before[:, :, None]).reshape(-1)[:n]
    dist = dist_at.astype(np.int64)[np.clip(seg, 0, n - 1)]
    d1 = np.maximum(dist, 1)
    i = np.arange(n, dtype=np.int64)
    hop = seg - d1 + np.mod(i - seg, d1)
    buf = [np.clip(np.where((dist > 0) & (seg >= 0), hop, i), 0, n - 1),
           np.zeros(n, np.int64)]
    # 4. the round launches: round r reads buffer (r - 1) % 2, writes r % 2.
    for r in range(1, ROUNDS + 1):
        if r > 1 and flags[r - 1] == 0:
            continue
        src = buf[(r - 1) % 2]
        buf[r % 2] = src[src]
        if (buf[r % 2] != src).any():
            flags[r] = 1
    # 5. the gather from buffer 0, and the rounds from the flags.
    parent = buf[0]
    rounds = 1
    while rounds < ROUNDS and flags[rounds]:
        rounds += 1
    return (litval[parent] & 0xFF).astype(np.uint8), parent, rounds


# ---------------------------------------------------------------------------
# Real groups: the arrays each decode path hands the two wrappers.
# ---------------------------------------------------------------------------


def _v2(out):
    """The same body behind a legacy v2 'ZZ' subfield (no anchors)."""
    header_len, cb, _t, chunks = containers.parse_gzip_index(out)
    sub = bytearray(struct.pack("<BBII", 2, 0, cb, len(chunks)))
    for seg_bytes, blocks, _anchors in chunks:
        sub += struct.pack("<IH", seg_bytes, len(blocks))
        for bit_off, out_off in blocks:
            sub += struct.pack("<II", bit_off, out_off)
    extra = b"ZZ" + struct.pack("<H", len(sub)) + bytes(sub)
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", len(extra)) + extra + out[header_len:])


def _recorded(blob):
    """Every token_scatter and resolve_lz call of one CPU device decode of
    an indexed stream, as numpy arrays taken before each call."""
    calls = {"token_scatter": [], "resolve_lz": []}
    orig = {k: getattr(kernels, k) for k in calls}

    def rec(name):
        def fn(*args):
            calls[name].append(tuple(a.numpy().copy() for a in args))
            return orig[name](*args)
        return fn

    mp = pytest.MonkeyPatch()
    try:
        for k in calls:
            mp.setattr(kernels, k, rec(k))
        out = idv.decompress_indexed(blob, device="cpu")
    finally:
        mp.undo()
    return out, calls


@pytest.fixture(scope="module")
def groups():
    """{'walk': resolve args, 'v2': resolve args, 'v2 scatter': args}."""
    rng = np.random.default_rng(9)
    walk = (b"dyn text block " * 600
            + rng.integers(0, 256, 4096, dtype=np.uint8).tobytes() + b"ab")
    blob = zt.compress(walk, level=6, format="gzip", chunk_bytes=4096,
                       indexed=True, device="cpu")
    out, calls = _recorded(blob)
    assert out == walk and not calls["token_scatter"]
    assert len(calls["resolve_lz"]) == 1
    got = {"walk": calls["resolve_lz"][0]}
    data = mixed_corpus(60000, seed=5)
    blob = _v2(zt.compress(data, level=6, format="gzip", chunk_bytes=4096,
                           indexed=True, device="cpu"))
    out, calls = _recorded(blob)
    assert out == data
    assert len(calls["token_scatter"]) == len(calls["resolve_lz"]) == 1
    got["v2"] = calls["resolve_lz"][0]
    got["v2 scatter"] = calls["token_scatter"][0]
    return got


def _check_resolve(litval, start_mark, dist_at):
    """Plain version, mirror and reference equal; returns the rounds."""
    n = start_mark.shape[0]
    t = torch.from_numpy
    parent, rounds = kernels.resolve_parent_plain(t(start_mark), t(dist_at))
    out = kernels.resolve_lz_plain(t(litval), t(start_mark), t(dist_at))
    m_out, m_parent, m_rounds = _resolve_mirror(litval, start_mark, dist_at)
    e_parent = np.asarray(_ref_parent(jnp.asarray(start_mark),
                                      jnp.asarray(dist_at), n))
    e_out = np.asarray(_ref_lz(jnp.asarray(litval), jnp.asarray(start_mark),
                               jnp.asarray(dist_at), n))
    np.testing.assert_array_equal(parent.numpy(), e_parent)
    np.testing.assert_array_equal(m_parent, e_parent)
    np.testing.assert_array_equal(out.numpy(), e_out)
    np.testing.assert_array_equal(m_out, e_out)
    assert rounds == m_rounds
    return rounds


@pytest.mark.parametrize("path", ["walk", "v2"])
def test_resolve_on_real_groups_matches_reference(groups, path):
    litval, start_mark, dist_at = groups[path]
    assert (dist_at > 0).any() and (start_mark == -1).any()
    assert 1 < _check_resolve(litval, start_mark, dist_at) < ROUNDS


@pytest.mark.parametrize("case", RESOLVE_CASES)
def test_resolve_on_hostile_arrays_matches_reference(case):
    rounds = _check_resolve(*resolve_inputs(case, N_HOSTILE))
    # A chain d deep takes ceil(log2 d) rounds and one that changes nothing.
    want = {"chain_2e20": 21, "full_chain": 22}
    if case in want:
        assert rounds == want[case]


def test_first_hops_never_cycle():
    """On any start_mark and dist_at, not only a decoder's, the first hops
    form a forest (a hop keeps i mod d and lands in [seg - d, seg)), so
    doubling settles and the 40-round cap stops only chains deeper than
    2^39: on seeded small arrays every chase reaches a root."""
    rng = np.random.default_rng(11)
    for _ in range(3000):
        n = int(rng.integers(2, 12))
        start_mark = rng.integers(-1, 2 * n, n).astype(np.int32)
        dist_at = rng.integers(-2, n + 3, n).astype(np.int32)
        _out, parent, rounds = _resolve_mirror(np.zeros(n, np.int32),
                                               start_mark, dist_at)
        assert rounds < ROUNDS and (parent[parent] == parent).all()


# ---------------------------------------------------------------------------
# token_scatter.
# ---------------------------------------------------------------------------


def _check_scatter(base, ins):
    """Plain version, mirror and reference equal; returns the result."""
    t = torch.from_numpy
    got = kernels.token_scatter_plain(*(t(a.copy()) for a in base),
                                      *(t(a) for a in ins))
    mirror = _scatter_mirror(*base, *ins)
    off, committed, islit, islen, sym, mdist = ins
    exp = _ref_scatter(*(jnp.asarray(a) for a in base),
                       jnp.asarray(off.astype(np.int32)),
                       jnp.asarray(committed), jnp.asarray(islit),
                       jnp.asarray(islen), jnp.asarray(sym.astype(np.int32)),
                       jnp.asarray(mdist.astype(np.int32)))
    for g, m, e in zip(got, mirror, exp):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
        np.testing.assert_array_equal(m, np.asarray(e))
    return mirror


def test_token_scatter_on_the_v2_group_matches_reference(groups):
    args = groups["v2 scatter"]
    base, ins = args[:3], args[3:]
    assert ins[0].dtype == np.int64 and ins[1].dtype == bool
    assert ins[4].dtype == ins[5].dtype == np.int32  # decode_candidates
    lv, sm, da = _check_scatter(base, ins)
    # The scatter's result is what the resolve then took.
    for g, r in zip((lv, sm, da), groups["v2"]):
        np.testing.assert_array_equal(g, r)
    committed = ins[1]
    assert 1000 < committed.sum() < committed.size // 4


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_token_scatter_on_hostile_inputs_matches_reference(case):
    base, ins = scatter_inputs(case, SCATTER_BITS, SCATTER_OUT)
    off, committed = ins[0], ins[1]
    assert (committed & (off >= SCATTER_OUT)).any()  # dropped tokens
    _check_scatter(base, ins)


def test_packed_max_would_differ_on_a_shared_slot():
    """Where a literal and a match share a slot the walk's packed word
    dist << 9 | lit << 1 | 1, maxed as one, keeps the match's zero
    literal; the reference's per-bit path maxes each field on its own."""
    base, ins = scatter_inputs("same_slot", SCATTER_BITS, SCATTER_OUT)
    lv, sm, da = _check_scatter(base, ins)
    off, committed, islit, islen, sym, mdist = ins
    ok = committed & (islit | islen) & (off < SCATTER_OUT)
    packed = np.where(base[1] >= 0, (base[2].astype(np.int64) << 9)
                      | (base[0].astype(np.int64) << 1) | 1, 0)
    np.maximum.at(packed, off[ok],
                  (np.where(islen[ok], mdist[ok], 0) << 9)
                  | (np.where(islit[ok], sym[ok], 0) << 1) | 1)
    assert ((packed >> 1) & 0xFF != lv).any()
    np.testing.assert_array_equal(packed >> 9, da)


def test_token_scatter_drops_negative_offsets():
    """The kernel drops an offset below 0 as one at or past the end (the
    decoder's are never negative; the reference would wrap one)."""
    base, ins = scatter_inputs("random", SCATTER_BITS, SCATTER_OUT)
    off = ins[0].copy()
    tok = np.flatnonzero(ins[1])[:500]
    off[tok] = -1 - np.arange(tok.size)
    t = torch.from_numpy
    got = kernels.token_scatter_plain(*(t(a.copy()) for a in base), t(off),
                                      *(t(a) for a in ins[1:]))
    mirror = _scatter_mirror(*base, off, *ins[1:])
    for g, m in zip(got, mirror):
        np.testing.assert_array_equal(g.numpy(), m)


# ---------------------------------------------------------------------------
# Wrappers: constants, routing, checks.
# ---------------------------------------------------------------------------


def test_resolve_constants_match_kernels_header():
    src = (Path(kernels.__file__).resolve().parent.parent / "csrc"
           / "kernels.h").read_text()
    for name in ("THREADS", "STEPS", "ROUNDS"):
        m = re.search(rf"#define ZZ_RESOLVE_{name} (\d+)", src)
        assert int(m.group(1)) == getattr(kernels, f"RESOLVE_{name}")
    assert "ZZ_RESOLVE_TILE (ZZ_RESOLVE_THREADS * ZZ_RESOLVE_STEPS)" in src


def test_cpu_tensors_take_the_plain_versions(groups):
    litval, start_mark, dist_at = (torch.from_numpy(a) for a in groups["v2"])
    before = dict(kernels.launches)
    out = kernels.resolve_lz(litval, start_mark, dist_at)
    assert out.dtype == torch.uint8 and out.shape == litval.shape
    assert torch.equal(out, kernels.resolve_lz_plain(litval, start_mark,
                                                     dist_at))
    parent, rounds = idv._resolve_parent(start_mark, dist_at,
                                         start_mark.shape[0])
    e_parent, e_rounds = kernels.resolve_parent_plain(start_mark, dist_at)
    assert torch.equal(parent, e_parent) and rounds == e_rounds
    assert torch.equal(idv._resolve_lz(litval, start_mark, dist_at,
                                       start_mark.shape[0]), out)
    args = [torch.from_numpy(a.copy()) for a in groups["v2 scatter"]]
    got = kernels.token_scatter(*args)
    assert all(g is a for g, a in zip(got, args))  # updated in place
    assert kernels.launches == before


class _OnCard(torch.Tensor):
    """A CPU tensor whose device says cuda: the route a card would take."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(a):
    return torch.Tensor._make_subclass(_OnCard, torch.from_numpy(a.copy()))


@pytest.mark.parametrize("name", ["token_scatter", "resolve_lz",
                                  "resolve_parent"])
def test_cuda_call_without_a_card_raises(groups, name, monkeypatch):
    """A CUDA tensor goes to the kernel or raises: without a card it
    raises, and the plain version never runs."""
    def no_plain(*a):
        raise AssertionError("fell back to the plain version")

    for k in ("token_scatter_plain", "resolve_lz_plain",
              "resolve_parent_plain"):
        monkeypatch.setattr(kernels, k, no_plain)
    args = {"token_scatter": groups["v2 scatter"],
            "resolve_lz": groups["v2"], "resolve_parent": groups["v2"][1:]}
    before = dict(kernels.launches)
    with pytest.raises((RuntimeError, AssertionError)) as err:
        getattr(kernels, name)(*(_on_card(a) for a in args[name]))
    assert "plain version" not in str(err.value)
    assert kernels.launches == before


def _bad_calls():
    i32 = torch.zeros(8, dtype=torch.int32)
    i64 = torch.zeros(16, dtype=torch.int64)
    b = torch.zeros(16, dtype=torch.bool)
    ok = (i64, b, b, b, i64, i64)
    return {
        "scatter int64 litval": (lambda: kernels.token_scatter(
            i32.long(), i32, i32, *ok), TypeError),
        "scatter 2-D start_mark": (lambda: kernels.token_scatter(
            i32, i32.reshape(2, 4), i32, *ok), ValueError),
        "scatter outputs differ": (lambda: kernels.token_scatter(
            i32, i32[:4].clone(), i32, *ok), ValueError),
        "scatter int32 mask": (lambda: kernels.token_scatter(
            i32, i32, i32, i64, b.int(), b, b, i64, i64), TypeError),
        "scatter float sym": (lambda: kernels.token_scatter(
            i32, i32, i32, i64, b, b, b, i64.float(), i64), TypeError),
        "scatter short islen": (lambda: kernels.token_scatter(
            i32, i32, i32, i64, b, b, b[:3], i64, i64), ValueError),
        "resolve int64": (lambda: kernels.resolve_lz(
            i32.long(), i32, i32), TypeError),
        "resolve shapes differ": (lambda: kernels.resolve_lz(
            i32, i32, i32[:4].clone()), ValueError),
        "resolve strided": (lambda: kernels.resolve_lz(
            i32, torch.zeros(16, dtype=torch.int32)[::2], i32), ValueError),
        "parent shapes differ": (lambda: kernels.resolve_parent(
            i32, i32[:4].clone()), ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_wrappers_reject_bad_arguments(case):
    call, exc = _bad_calls()[case]
    with pytest.raises(exc):
        call()
