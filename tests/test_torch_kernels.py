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
        (lambda: kernels.scan_candidates(
            torch.zeros((2, 8), dtype=torch.int32),
            torch.zeros((2, 9), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), 4, 16), ValueError),
    ],
    ids=["dtype", "ndim", "contiguity", "row", "shape"],
)
def test_wrappers_reject_what_the_kernels_do_not_take(call, exc):
    with pytest.raises(exc):
        call()
