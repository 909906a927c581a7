"""The port's matcher against the JAX package's, on the CPU.

find_matches at L1 (K=4, 16-byte keys, full-width extension) and L6
(K=16, 64-byte keys, stride-32 anchors) on text, binary, all-zero and
window-edge rows; parse_commit_batch greedy and lazy, on a synthetic
fixture and on the reference's own find_matches output. Inputs come from
numpy with fixed seeds and go through both packages. Tolerance is zero:
the codec is integer-only and deterministic.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zzflate_tpu.config import LEVELS as JAX_LEVELS
from zzflate_tpu.ops import matcher as jax_matcher
from zzflate_tpu_torch.ops import matcher
from zzflate_tpu_torch.utils.corpus import mixed_corpus

N = 32768 + 4096  # one chunk row at chunk_bytes=4096


def _rows():
    """(data (4, N) uint8, valid_end (4,), window_start (4,))."""
    rng = np.random.default_rng(11)
    text = np.frombuffer(mixed_corpus(N, 3)[:N], np.uint8)
    binary = np.frombuffer(mixed_corpus(3 * N, 5)[2 * N:3 * N], np.uint8)
    zeros = np.zeros(N, np.uint8)
    # Window edge: a block repeated at distance exactly 32768 (accepted)
    # and one farther (rejected); sources below window_start are padding.
    edge = rng.integers(0, 256, N, dtype=np.uint8)
    edge[32768:34768] = edge[0:2000]
    edge[34800:35800] = edge[31:1031]
    data = np.stack([text, binary, zeros, edge]).astype(np.uint8)
    valid_end = np.array([N, N, 30000, N], np.int32)
    data[2, 30000:] = 0
    window_start = np.array([0, 32768 - 100, 0, 5], np.int32)
    return data, valid_end, window_start


@pytest.fixture(scope="module")
def rows():
    return _rows()


@pytest.fixture(scope="module", params=[1, 6], ids=["L1", "L6"])
def reference_matches(request, rows):
    """The JAX package's find_matches, one row at a time."""
    level = request.param
    p = JAX_LEVELS[level]
    data, valid_end, window_start = rows
    out = [
        jax_matcher.find_matches(
            jnp.asarray(data[r]), jnp.int32(valid_end[r]),
            jnp.int32(window_start[r]), p.candidates, key_words=p.key_words,
        )
        for r in range(data.shape[0])
    ]
    mlen = np.stack([np.asarray(m) for m, _ in out])
    mdist = np.stack([np.asarray(d) for _, d in out])
    return level, mlen, mdist


def test_find_matches_equals_reference(rows, reference_matches):
    level, exp_len, exp_dist = reference_matches
    p = JAX_LEVELS[level]
    data, valid_end, window_start = rows
    mlen, mdist = matcher.find_matches(
        torch.as_tensor(data), torch.as_tensor(valid_end),
        torch.as_tensor(window_start), p.candidates, key_words=p.key_words,
    )
    np.testing.assert_array_equal(mlen.numpy(), exp_len)
    np.testing.assert_array_equal(mdist.numpy(), exp_dist)
    # The fixtures do exercise matches, long ones and the window edge.
    assert (exp_len > 0).sum() > 1000
    assert exp_len.max() == 258
    assert exp_dist[3].max() == 32768
    assert (exp_dist[3] > 0)[32768:32773].sum() == 0  # sources < window_start


def _parse_both(mlen, mdist, starts, vends, lazy, max_lazy, nice):
    c1, t1 = jax_matcher.parse_commit_batch(
        jnp.asarray(mlen), jnp.asarray(mdist), jnp.asarray(starts),
        jnp.asarray(vends), lazy, max_lazy, nice,
    )
    c2, t2 = matcher.parse_commit_batch(
        torch.as_tensor(mlen), torch.as_tensor(starts),
        torch.as_tensor(vends), lazy, max_lazy, nice,
    )
    np.testing.assert_array_equal(c2.numpy(), np.asarray(c1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(t1))
    assert np.asarray(c1).sum() > 0


@pytest.mark.parametrize("lazy", [False, True], ids=["greedy", "lazy"])
def test_parse_commit_batch_equals_reference(lazy):
    """npad != n and a nonzero start (tests/test_pallas.py's fixture)."""
    rng = np.random.default_rng(7)
    b, n = 2, 2048 + 123
    mlen = np.where(
        rng.random((b, n)) < 0.3, rng.integers(3, 259, (b, n)), 0
    ).astype(np.int32)
    mdist = np.where(mlen > 0, rng.integers(1, 1000, (b, n)), 0).astype(
        np.int32
    )
    _parse_both(mlen, mdist, np.array([700, 0], np.int32),
                np.array([n - 9, n], np.int32), lazy, 16, 128)


def test_parse_of_reference_matches(rows, reference_matches):
    """The reference's own (mlen, mdist) through both parses, with the
    level's lazy settings: a mismatch here is the parse's alone."""
    level, mlen, mdist = reference_matches
    p = JAX_LEVELS[level]
    _, valid_end, _ = rows
    starts = np.full(mlen.shape[0], 32768, np.int32)
    _parse_both(mlen, mdist, starts, valid_end, p.lazy_mode, p.max_lazy,
                p.nice)
