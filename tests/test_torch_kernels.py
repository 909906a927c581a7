"""The port's three kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain torch version; those must equal
the Pallas functions run in interpret mode on the same numpy inputs
(the fixtures of tests/test_pallas.py). Tolerance is zero: the codec is
integer-only and deterministic, so any difference is a bug. The CUDA
kernels are held against the plain versions by tests/test_torch_cuda.py,
on a card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zzflate_tpu.constants import WINDOW_SIZE
from zzflate_tpu.ops import pallas_kernels as pk
from zzflate_tpu_torch.ops import kernels

# The test processes share the CPU. With torch's default intra-op pool in
# each of them it is oversubscribed, and a CPU-path call runs tens of
# times slower; one thread apiece keeps the suite inside its time limit.
torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32))


def _scan_both(adj, spos, ws, k_each, backward_only, lcp_cap=16):
    got = kernels.scan_candidates(
        _t(adj)[None], _t(spos)[None], _t([ws]), k_each, lcp_cap,
        backward_only,
    )
    exp = pk.scan_candidates(
        jnp.asarray(adj, jnp.int32), jnp.asarray(spos, jnp.int32),
        jnp.int32(ws), k_each, lcp_cap=lcp_cap,
        backward_only=backward_only, interpret=True,
    )
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(e))


@pytest.mark.parametrize("backward_only", [False, True])
@pytest.mark.parametrize("k_each", [1, 8, 16])
def test_scan_plain_matches_pallas(k_each, backward_only):
    rng = np.random.default_rng(k_each + int(backward_only))
    n = 1000  # not a multiple of any tile: exercises the row edges
    _scan_both(rng.integers(0, 17, size=n), rng.permutation(n), 37, k_each,
               backward_only)


def test_scan_plain_window_edges():
    # Positions straddling the 32 KiB window limit.
    n = 512
    spos = np.concatenate([[0], np.arange(WINDOW_SIZE, WINDOW_SIZE + n - 1)])
    _scan_both(np.full(n, 16), spos, 0, 4, False)


def test_scan_plain_batch_rows_are_independent():
    """A batch of rows gives each row's single-row result: neighbours
    never cross a row boundary, and window_start is read per row."""
    rng = np.random.default_rng(3)
    b, n = 3, 777
    adj = rng.integers(0, 65, size=(b, n))
    spos = np.stack([rng.permutation(n) for _ in range(b)])
    ws = np.array([0, 100, 400])
    s_len, s_dist = kernels.scan_candidates(_t(adj), _t(spos), _t(ws), 16,
                                            64, False)
    for r in range(b):
        e_len, e_dist = pk.scan_candidates(
            jnp.asarray(adj[r], jnp.int32), jnp.asarray(spos[r], jnp.int32),
            jnp.int32(ws[r]), 16, lcp_cap=64, interpret=True,
        )
        np.testing.assert_array_equal(s_len[r].numpy(), np.asarray(e_len))
        np.testing.assert_array_equal(s_dist[r].numpy(), np.asarray(e_dist))


_PAD_POS = -(1 << 30)


def _scan_mirror(adj, spos, ws, k_each, lcp_cap, backward_only, e=4):
    """csrc/scan.cu's arithmetic in numpy, in its order: each row cut into
    tiles of 256 threads x e elements staged with an H-wide halo (LCP 0,
    position -2^30 outside the row), each thread's e elements scored from
    its window of e + 2H values; LCPs clamped to [0, cap] and shifted into
    the key's length field, the one-range unsigned test with the
    empty-range guard,
    the add-max per candidate, and the unpack at the end."""
    adj = np.asarray(adj, np.int64)
    spos = np.asarray(spos, np.int64)
    b, n = adj.shape
    threads, h = 256, (k_each + 3) & ~3
    tile = threads * e
    ntiles = -(-n // tile)
    tail = ntiles * tile - n + h
    out_len = np.zeros((b, n), np.int64)
    out_dist = np.zeros((b, n), np.int64)
    for r in range(b):
        sa = np.concatenate([np.zeros(h), adj[r], np.zeros(tail)])
        sp = np.concatenate([np.full(h, _PAD_POS), spos[r],
                             np.full(tail, _PAD_POS)]).astype(np.int64)
        for t in range(ntiles):
            idx = (t * tile + np.arange(threads)[:, None] * e
                   + np.arange(e + 2 * h)[None, :])
            wa = np.clip(sa[idx].astype(np.int64), 0, lcp_cap) << 15
            wp = sp[idx]
            for el in range(e):
                c = h + el
                p0 = wp[:, c]
                lo = np.maximum(ws[r], p0 - WINDOW_SIZE)
                span = p0 - 1 - lo
                empty = span < 0
                lo = np.where(empty, 2 ** 31 - 1, lo)
                span = np.where(empty, 0, span)
                best = p0 - WINDOW_SIZE - 1
                for d in (-1,) if backward_only else (-1, 1):
                    m = np.full_like(p0, lcp_cap << 15)
                    for k in range(1, k_each + 1):
                        m = np.minimum(m, wa[:, c - k + 1] if d < 0
                                       else wa[:, c + k])
                        cpos = wp[:, c + d * k]
                        ok = ((cpos - lo) & 0xFFFFFFFF) <= span
                        key = m + cpos
                        assert np.all(np.abs(key[ok]) < 2 ** 31)
                        best = np.where(ok, np.maximum(key, best), best)
                kt = np.maximum(best + WINDOW_SIZE - p0, 0)
                ln = kt >> 15
                i = t * tile + np.arange(threads) * e + el
                keep = i < n
                out_len[r, i[keep]] = ln[keep]
                out_dist[r, i[keep]] = np.where(
                    ln > 0, WINDOW_SIZE - (kt & (WINDOW_SIZE - 1)), 0)[keep]
    return out_len, out_dist


def _scan_case(name, rng):
    """(adj, spos, ws, lcp_cap) of one named case, (B, n) arrays."""
    if name == "random":
        n, cap = 1000, 32
        adj = rng.integers(0, cap + 8, (2, n))
        spos = np.stack([rng.permutation(n) for _ in range(2)])
        return adj, spos, np.array([37, 0]), cap
    if name == "ties":
        # Every length equal to the cap, and repeated positions: ties in
        # length at different and at equal distances (and distance 0).
        n, cap = 600, 16
        return (np.full((2, n), cap), rng.integers(0, n // 3, (2, n)),
                np.array([0, 50]), cap)
    if name == "zero-lcp":
        n, cap = 800, 64
        adj = np.where(rng.random((2, n)) < 0.5, 0, rng.integers(1, 70, (2, n)))
        spos = np.stack([rng.permutation(n) for _ in range(2)])
        return adj, spos, np.array([0, 0]), cap
    if name == "empty-range":
        # window_start past every position, and mid-row.
        n, cap = 700, 32
        adj = rng.integers(0, 40, (2, n))
        spos = np.stack([rng.permutation(n) for _ in range(2)])
        return adj, spos, np.array([n + 100, n // 2]), cap
    if name == "window-edge":
        # Neighbours at distances 32767, 32768 and 32769.
        n, cap = 300, 16
        spos = np.arange(n) * WINDOW_SIZE + (np.arange(n) % 3 == 0)
        spos = np.stack([spos, spos[::-1].copy()])
        return rng.integers(0, 20, (2, n)), spos, np.array([0, 0]), cap
    if name == "row-ends":
        # Three short rows: most neighbours fall outside their row.
        n, cap = 37, 64
        adj = rng.integers(0, 70, (3, n))
        spos = np.stack([rng.permutation(n) for _ in range(3)])
        return adj, spos, np.array([0, 5, 0]), cap
    if name == "n-below-k":
        n, cap = 5, 16
        adj = rng.integers(0, 20, (2, n))
        spos = np.stack([rng.permutation(n) for _ in range(2)])
        return adj, spos, np.array([0, 0]), cap
    if name == "negative-lcp":
        # Negative LCPs count as 0: no candidate past one.
        n, cap = 600, 32
        adj = rng.integers(-40, 40, (2, n))
        spos = np.stack([rng.permutation(n) for _ in range(2)])
        return adj, spos, np.array([0, 9]), cap
    assert name == "cap-0"
    n = 500
    adj = rng.integers(0, 20, (2, n))
    spos = np.stack([rng.permutation(n) for _ in range(2)])
    return adj, spos, np.array([0, 0]), 0


def _scan_mirror_check(name, k_each, backward_only, cap=None):
    rng = np.random.default_rng([k_each, int(backward_only), len(name)])
    adj, spos, ws, case_cap = _scan_case(name, rng)
    cap = case_cap if cap is None else cap
    got = _scan_mirror(adj, spos, ws, k_each, cap, backward_only)
    plain = kernels.scan_candidates_plain(_t(adj), _t(spos), _t(ws),
                                          k_each, cap, backward_only)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())
    for r in range(adj.shape[0]):
        exp = pk.scan_candidates(
            jnp.asarray(adj[r], jnp.int32), jnp.asarray(spos[r], jnp.int32),
            jnp.int32(ws[r]), k_each, lcp_cap=cap,
            backward_only=backward_only, interpret=True,
        )
        for g, x in zip(got, exp):
            np.testing.assert_array_equal(g[r], np.asarray(x))


@pytest.mark.parametrize("backward_only", [False, True],
                         ids=["both", "backward"])
@pytest.mark.parametrize("k_each", [1, 4, 6, 8, 12, 16, 64])
def test_scan_kernel_arithmetic_every_k(k_each, backward_only):
    """The kernel's formulation (packed key, folded range test, add-max,
    unpack) in register-window order equals scan_candidates_plain and the
    JAX scan_candidates for every K the levels use and the runtime-K
    instance's 1 and 64, at lcp_cap 16, 32 and 64."""
    cap = (16, 32, 64)[k_each % 3]
    _scan_mirror_check("random", k_each, backward_only, cap)


@pytest.mark.parametrize("k_each, backward_only", [(16, False), (4, True)],
                         ids=["k16-both", "k4-backward"])
@pytest.mark.parametrize("case", ["ties", "zero-lcp", "empty-range",
                                  "window-edge", "row-ends", "n-below-k",
                                  "cap-0", "negative-lcp"])
def test_scan_kernel_arithmetic_edge_cases(case, k_each, backward_only):
    _scan_mirror_check(case, k_each, backward_only)


def _packed(rng, n, max_len=258):
    mlen = rng.integers(3, max_len + 1, size=n).astype(np.int32)
    mlen = np.where(rng.random(n) < 0.6, 0, mlen)
    mdist = rng.integers(1, 32769, size=n).astype(np.int32)
    return np.where(mlen > 0, (mlen << 15) | (WINDOW_SIZE - mdist), 0)


@pytest.mark.parametrize("n", [1000, 4096, 12345])
def test_propagate_plain_matches_pallas(n):
    packed = _packed(np.random.default_rng(n), n)
    got = kernels.propagate_matches(_t(packed)[None])[0].numpy()
    exp = np.asarray(pk.propagate_matches(jnp.asarray(packed, jnp.int32),
                                          interpret=True))
    np.testing.assert_array_equal(got, exp)


def _jax_doubling(packed):
    """The reference's CPU formulation (zzflate_tpu/ops/matcher.py:419-426)."""
    x = jnp.asarray(packed, jnp.int32)
    pos = jnp.arange(x.shape[0], dtype=jnp.int32)
    shift = 1
    while shift < 258:
        cand = jnp.roll(x, shift) - (shift << 15)
        cand = jnp.where((pos >= shift) & (cand >= (3 << 15)), cand, 0)
        x = jnp.maximum(x, cand)
        shift *= 2
    return np.asarray(x)


def test_propagate_plain_keeps_the_reference_512_window():
    """Lengths above 258 reach the propagation (the extension ladder
    yields up to ~400 at L6): the reference's CPU path then carries a
    match up to 511 positions on, while the TPU kernel's 256-wide window
    stops at 255. The port follows the CPU path, whose bytes it matches."""
    n = 2048
    packed = np.zeros(n, np.int32)
    packed[100] = (400 << 15) | (WINDOW_SIZE - 7)  # reaches 100 + 397
    packed[1000] = (2 << 15) | (WINDOW_SIZE - 3)  # length 2 is kept as is
    got = kernels.propagate_matches(_t(packed)[None])[0].numpy()
    np.testing.assert_array_equal(got, _jax_doubling(packed))
    assert got[100 + 300] >> 15 == 100
    tpu = np.asarray(pk.propagate_matches(jnp.asarray(packed),
                                          interpret=True))
    assert tpu[100 + 300] == 0


_C = 1 << 15
_NEG = -(1 << 30)
_PROP_TILE = 8 * 512  # csrc/propagate.cu: kWarps blocks of kReach


def _prop_mirror(pk):
    """csrc/propagate.cu's arithmetic in numpy, in its order: each row cut
    into tiles of 8 blocks of 512 aligned to the row start, with one halo
    block in front (0 outside the row); offsets taken down from the tile's
    end E, u = pk - (E - m) * 2^15, held to int32; per block the prefix max
    and the max over the positions after each element; M = max(prefix, the
    block before's after-max); then + (E - i) * 2^15 and the gate."""
    pk = np.asarray(pk, np.int64)
    b, n = pk.shape
    out = np.zeros((b, n), np.int64)
    for r in range(b):
        for t in range(-(-n // _PROP_TILE)):
            end = (t + 1) * _PROP_TILE
            idx = t * _PROP_TILE - 512 + np.arange(_PROP_TILE + 512)
            v = np.where((idx >= 0) & (idx < n), pk[r, np.clip(idx, 0, n - 1)],
                         0)
            u = v - (end - idx) * _C
            assert u.min() >= -2 ** 31 and u.max() < 2 ** 31
            blk = u.reshape(-1, 512)
            pre = np.maximum.accumulate(blk, axis=1)
            suf = np.maximum.accumulate(blk[:, ::-1], axis=1)[:, ::-1]
            after = np.concatenate([suf[:, 1:], np.full((len(blk), 1), _NEG)],
                                   axis=1)
            m = np.maximum(pre[1:], after[:-1]).reshape(-1) + (end - idx[512:]) * _C
            assert m.max() < 2 ** 31
            res = np.where(m >= 3 * _C, m, v[512:])
            keep = idx[512:] < n
            out[r, idx[512:][keep]] = res[keep]
    return out


def _pack(length, dist):
    return (np.asarray(length, np.int64) << 15) | (WINDOW_SIZE - np.asarray(dist))


# name: (B, n, lengths). Tiles are 4096 positions (8 blocks of 512).
_PROP_CASES = {
    "n-below-512": (2, 300, "random"),
    "n-512": (1, 512, "random"),
    "tile-minus-1": (2, 4095, "random"),
    "tile-plus-1-rows-differ": (3, 4097, "random"),
    "n-mod-4-is-1": (2, 5001, "random"),
    "all-zero": (2, 1500, "zero"),
    "all-match": (2, 1500, "all"),
    "lengths-1-2": (2, 1500, "short"),
    "ties": (2, 1500, "ties"),
    "window-edge": (2, 1300, "edge"),
    "lengths-to-65535": (2, 9000, "long"),
}


def _prop_case(name):
    """(B, n) packed input of one named case."""
    b, n, kind = _PROP_CASES[name]
    rng = np.random.default_rng(list(_PROP_CASES).index(name))
    dist = rng.integers(1, WINDOW_SIZE + 1, (b, n))
    if kind == "zero":
        return np.zeros((b, n), np.int32)
    if kind == "edge":
        # A length of 514 reaches 511 on (length 3, kept); 515 would be
        # length 3 at 512 on, one past the window (not carried).
        pk = np.zeros((b, n), np.int64)
        pk[0, 100] = _pack(514, 7)
        pk[1, 100] = _pack(515, 9)
        pk[0, 700] = _pack(3, 5)
        return pk.astype(np.int32)
    lo, hi, density = {"random": (3, 259, 0.4), "all": (3, 259, 1.0),
                       "short": (1, 5, 0.6), "ties": (3, 7, 0.7),
                       "long": (3, 65536, 0.05)}[kind]
    length = rng.integers(lo, hi, (b, n))
    if kind == "long":
        # The domain's edge at both ends of the range, and mid-row.
        length[:, :3] = [65535, 65535, 259]
        length[:, n // 2] = 65535
    keep = rng.random((b, n)) < density
    keep[:, :3] |= kind == "long"
    return np.where(keep, _pack(length, dist), 0).astype(np.int32)


@pytest.mark.parametrize("case", list(_PROP_CASES))
def test_propagate_kernel_arithmetic_edge_cases(case):
    """The kernel's formulation (512-aligned blocks, one halo block, offsets
    from the tile end, the gate after the offset is added back) equals
    propagate_matches_plain and the reference's doubling loop, and the JAX
    Pallas kernel where every length is in [3, 258] (its 256-wide window is
    exact only up to 258, and it gates lengths 1-2 to 0)."""
    packed = _prop_case(case)
    got = _prop_mirror(packed)
    plain = kernels.propagate_matches_plain(_t(packed)).numpy()
    np.testing.assert_array_equal(got, plain)
    lengths = packed >> 15
    short = ((lengths == 0) | ((lengths >= 3) & (lengths <= 258))).all()
    for r in range(packed.shape[0]):
        np.testing.assert_array_equal(got[r], _jax_doubling(packed[r]))
        if short:
            exp = pk.propagate_matches(jnp.asarray(packed[r]), interpret=True)
            np.testing.assert_array_equal(got[r], np.asarray(exp))
    if case == "window-edge":
        assert got[0, 100 + 511] == _pack(3, 7)
        assert got[0, 100 + 512] == 0
        assert got[1, 100 + 511] == _pack(4, 9)
        assert got[1, 100 + 512] == 0
        assert got[0, 701] == 0  # length 3 at 700 decays to 2: gated


def test_propagate_plain_maps_negative_entries_to_zero():
    """Outside the kernels' domain, [0, 2^31): the plain version takes
    max(pk, gated candidate or 0), so a negative entry becomes 0 (or a
    carried match); the CUDA kernel is not defined there."""
    got = kernels.propagate_matches_plain(_t([[-5, 0, 7 << 15, -3]]))
    np.testing.assert_array_equal(got.numpy(), [[0, 0, 7 << 15, 6 << 15]])


def _parse_fixture(lazy):
    from zzflate_tpu_torch.ops import matcher

    rng = np.random.default_rng(7)
    b, n = 2, 2048 + 123
    mlen = np.where(
        rng.random((b, n)) < 0.3, rng.integers(3, 259, (b, n)), 0
    ).astype(np.int32)
    take = matcher._lazy_take(torch.as_tensor(mlen), lazy, 258, 258)
    step = torch.where(take, torch.clamp(torch.as_tensor(mlen), min=1), 1)
    npad = -(-n // 512) * 512
    step = torch.nn.functional.pad(step, (0, npad - n), value=1).int()
    return step, np.array([700, 0], np.int32)


@pytest.mark.parametrize("lazy", [False, True])
def test_parse_rows_plain_matches_pallas(lazy):
    """npad != n and a nonzero start, greedy and lazy steps."""
    step, starts = _parse_fixture(lazy)
    got = kernels.parse_rows(step.contiguous(), _t(starts), 512).numpy()
    exp = np.asarray(pk.parse_rows(jnp.asarray(step.numpy()),
                                   jnp.asarray(starts), 512, interpret=True))
    np.testing.assert_array_equal(got, exp)
    assert got.sum() > 0


# name: (B, rows per chunk, starts, steps). Rows are 512 wide; the CUDA
# kernel cuts them into segments of 32.
_PARSE_CASES = {
    "start-0": (2, 5, [0, 0], "mixed"),
    "row-boundary": (2, 6, [3 * 512, 512], "mixed"),
    "later-segment-mid-row": (2, 40, [33 * 512 + 300, 39 * 512 + 7], "mixed"),
    "rows-not-multiple-of-32": (2, 37, [100, 31 * 512 + 511], "mixed"),
    "batch-1": (1, 9, [777], "mixed"),
    "all-literal": (2, 5, [5, 0], "literal"),
    "all-258": (2, 5, [0, 1000], "max"),
    "negative-start": (2, 5, [-5, -600], "mixed"),
    "start-past-end": (2, 5, [5 * 512, 5 * 512 + 9], "mixed"),
}


def _parse_case(name):
    b, rows, starts, kind = _PARSE_CASES[name]
    rng = np.random.default_rng(list(_PARSE_CASES).index(name))
    shape = (b, rows * 512)
    if kind == "literal":
        step = np.ones(shape)
    elif kind == "max":
        step = np.full(shape, 258)
    else:
        step = np.where(rng.random(shape) < 0.3,
                        rng.integers(3, 259, shape), 1)
    return step.astype(np.int32), np.array(starts, np.int32)


@pytest.mark.parametrize("case", list(_PARSE_CASES))
def test_parse_rows_edge_cases_match_pallas(case):
    step, starts = _parse_case(case)
    got = kernels.parse_rows(_t(step), _t(starts), 512).numpy()
    exp = np.asarray(pk.parse_rows(jnp.asarray(step), jnp.asarray(starts),
                                   512, interpret=True))
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("row", [384, 1024])
def test_parse_rows_other_row_widths_match_pallas(row):
    """The row widths the wrapper takes besides the main path's 512."""
    rng = np.random.default_rng(row)
    shape = (2, 11 * row)
    step = np.where(rng.random(shape) < 0.3, rng.integers(3, 259, shape),
                    1).astype(np.int32)
    starts = np.array([row * 4 + 100, 5], np.int32)
    got = kernels.parse_rows(_t(step), _t(starts), row).numpy()
    exp = np.asarray(pk.parse_rows(jnp.asarray(step), jnp.asarray(starts),
                                   row, interpret=True))
    np.testing.assert_array_equal(got, exp)
    _, _, mark = _segmented(step, starts, row, 4)
    np.testing.assert_array_equal(mark, got)


def _take(a, idx):
    return np.take_along_axis(a, np.minimum(idx, a.shape[-1] - 1)[..., None],
                              -1)[..., 0]


def _segmented(step, starts, row, g, parts=8):
    """The CUDA kernels' arithmetic (csrc/parse.cu) in numpy: the exits
    kernel's part sweeps, fix-up rounds and prefix tables, the start
    segment's chain and head; the marks kernel's chain over segment maps,
    part entries and part walks. Returns (entries, exits, mark)."""
    t = 258
    b, npad = step.shape
    rows_per = npad // row
    nseg = -(-rows_per // g)
    w = row // parts
    st = np.clip(step, 1, t).reshape(b, rows_per, row).astype(np.int64)
    land = np.zeros_like(st)  # first landing past the position's part
    for q in range(parts):
        end = (q + 1) * w
        for j in range(end - 1, q * w - 1, -1):
            to = j + st[:, :, j]
            land[:, :, j] = np.where(to >= end, to, _take(land, to))
    ex = land.copy()
    for q in range(parts - 1, -1, -1):
        cut = ex[:, :, q * w:(q + 1) * w]
        ex[:, :, q * w:(q + 1) * w] = np.where(
            cut >= row, cut - row,
            np.take_along_axis(ex, np.minimum(cut, row - 1), 2))
    pre = np.zeros((b, rows_per, t), np.int64)
    for s in range(nseg):
        x = np.tile(np.arange(t), (b, 1))
        for r in range(s * g, min((s + 1) * g, rows_per)):
            x = np.take_along_axis(ex[:, r, :], x, 1)
            pre[:, r] = x
    ent = np.full((b, rows_per), -1, np.int64)
    for i in range(b):
        r0, off = divmod(max(int(starts[i]), 0), row)
        if r0 >= rows_per:
            continue
        x = off  # exits kernel, the block holding r0
        for r in range(r0, min((r0 // g + 1) * g, rows_per)):
            ent[i, r] = x
            x = ex[i, r, x]
        for s in range(r0 // g + 1, nseg):  # marks kernel, from head
            last = min((s + 1) * g, rows_per) - 1
            for r in range(s * g + 1, last + 1):
                ent[i, r] = pre[i, r - 1, x]
            ent[i, s * g] = x
            x = pre[i, last, x]
    mark = np.zeros((b, rows_per, row), np.int32)
    for i in range(b):
        for r in range(rows_per):
            part_entry = {}
            j = ent[i, r]
            while 0 <= j < row:
                part_entry[j // w] = j
                j = land[i, r, j]
            for q, j in part_entry.items():
                while j < (q + 1) * w:
                    mark[i, r, j] = 1
                    j += st[i, r, j]
    return ent, ex, mark.reshape(b, npad)


@pytest.mark.parametrize("g", [4, 32])
@pytest.mark.parametrize("case", list(_PARSE_CASES))
def test_parse_rows_segment_chain_equals_serial_chain(case, g):
    """Rehearses the CUDA kernel's arithmetic on the CPU: its exits equal
    one reverse sweep of each whole row, the row entries it derives from
    prefix tables and segment maps equal the serial chain
    e_{r+1} = E_r(e_r) from the start, and its marks equal
    parse_rows_plain's."""
    step, starts = _parse_case(case)
    row = 512
    ent, ex, mark = _segmented(step, starts, row, g)
    st = np.clip(step, 1, 258).reshape(ex.shape).astype(np.int64)
    whole = np.zeros_like(ex)
    for j in range(row - 1, -1, -1):
        to = j + st[:, :, j]
        whole[:, :, j] = np.where(to >= row, to - row, _take(whole, to))
    np.testing.assert_array_equal(ex, whole)
    serial = np.full_like(ent, -1)
    for i in range(len(starts)):
        r0, x = divmod(max(int(starts[i]), 0), row)
        for r in range(r0, ent.shape[1]):
            serial[i, r] = x
            x = ex[i, r, x]
    np.testing.assert_array_equal(ent, serial)
    plain = kernels.parse_rows_plain(_t(step), _t(starts), row).numpy()
    np.testing.assert_array_equal(mark, plain)


def test_wrappers_route_cpu_tensors_to_plain_versions():
    step, starts = _parse_fixture(False)
    before = dict(kernels.launches)
    kernels.parse_rows(step.contiguous(), _t(starts), 512)
    kernels.propagate_matches(torch.zeros((1, 64), dtype=torch.int32))
    assert kernels.launches == before  # plain versions count no launch


@pytest.mark.parametrize(
    "call, exc",
    [
        (lambda: kernels.propagate_matches(torch.zeros((1, 8))), TypeError),
        (lambda: kernels.propagate_matches(
            torch.zeros(8, dtype=torch.int32)), ValueError),
        (lambda: kernels.propagate_matches(
            torch.zeros((8, 2), dtype=torch.int32).t()), ValueError),
        (lambda: kernels.parse_rows(torch.ones((1, 512), dtype=torch.int32),
                                    torch.zeros(1, dtype=torch.int32), 256),
         ValueError),
        (lambda: kernels.parse_rows(torch.ones((1, 600), dtype=torch.int32),
                                    torch.zeros(1, dtype=torch.int32), 300),
         ValueError),
        (lambda: kernels.scan_candidates(
            torch.zeros((2, 8), dtype=torch.int32),
            torch.zeros((2, 9), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), 4, 16), ValueError),
        (lambda: kernels.scan_candidates(
            torch.zeros((2, 8), dtype=torch.int32),
            torch.zeros((2, 8), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), 4, 1 << 15), ValueError),
        (lambda: kernels.scan_candidates(
            torch.zeros((2, 8), dtype=torch.int32),
            torch.zeros((2, 8), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), 4, -1), ValueError),
    ],
    ids=["dtype", "ndim", "contiguity", "row", "row-multiple", "shape",
         "lcp-cap-high", "lcp-cap-negative"],
)
def test_wrappers_reject_what_the_kernels_do_not_take(call, exc):
    with pytest.raises(exc):
        call()
