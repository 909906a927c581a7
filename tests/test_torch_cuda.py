"""The port on a CUDA card: kernels against their plain versions, and
compress() on the card against the CPU path, byte for byte.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither jax nor the JAX package, so it also runs on a machine
without them (tests/conftest.py does import jax; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance is zero: the codec is integer-only and deterministic.
"""
import zlib

import numpy as np
import pytest
import torch

import zzflate_tpu_torch as zt
from zzflate_tpu_torch.ops import kernels
from zzflate_tpu_torch.utils.corpus import mixed_corpus

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32)).cuda()


@pytest.mark.parametrize("n", [1000, 12345, 40000])
def test_kernels_match_plain_versions(n):
    _card()
    rng = np.random.default_rng(n)
    b = 3
    adj = _t(rng.integers(0, 65, (b, n)))
    spos = _t(np.stack([rng.permutation(n) for _ in range(b)]))
    ws = _t(rng.integers(0, n // 2, b))
    for k_each, cap, back in ((16, 64, False), (8, 16, True), (1, 16, False)):
        got = kernels.scan_candidates(adj, spos, ws, k_each, cap, back)
        exp = kernels.scan_candidates_plain(adj, spos, ws, k_each, cap, back)
        for g, e in zip(got, exp):
            assert torch.equal(g, e)
    # Lengths up to 400 exercise the 512-wide propagation window.
    mlen = np.where(rng.random((b, n)) < 0.4, rng.integers(3, 401, (b, n)), 0)
    packed = _t(np.where(mlen > 0,
                         (mlen << 15) | (32768 - rng.integers(1, 32769, (b, n))),
                         0))
    assert torch.equal(kernels.propagate_matches(packed),
                       kernels.propagate_matches_plain(packed))
    npad = -(-n // 512) * 512
    step = _t(np.where(rng.random((b, npad)) < 0.3,
                       rng.integers(3, 259, (b, npad)), 1))
    starts = _t(rng.integers(0, npad, b))
    before = kernels.launches["parse_rows"]
    assert torch.equal(kernels.parse_rows(step, starts, 512),
                       kernels.parse_rows_plain(step, starts, 512))
    assert kernels.launches["parse_rows"] == before + 1


DATA = mixed_corpus(20000, 31)
CASES = {
    "gzip": dict(format="gzip"),
    "raw": dict(format="raw"),
    "dictionary": dict(dictionary=mixed_corpus(6000, 32)[-5000:]),
    "window-bits-9": dict(window_bits=9),
    "filtered": dict(strategy=1),
    "huffman-only": dict(strategy=2),
    "rle": dict(strategy=3),
    "fixed": dict(strategy=4),
    "indexed": dict(format="gzip", indexed=True),
    "seekable": dict(format="gzip", indexed=True, seekable=True),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("level", [1, 6], ids=["L1", "L6"])
def test_compress_on_card_equals_cpu_path(level, case):
    _card()
    kw = CASES[case]
    gpu = zt.compress(DATA, level=level, chunk_bytes=4096, **kw)
    cpu = zt.compress(DATA, level=level, chunk_bytes=4096, device="cpu", **kw)
    assert gpu == cpu


def test_full_width_emit_on_card_equals_cpu_path():
    """Incompressible 64 KiB chunks exceed the compact token budget, so
    the batch takes the full-width emit."""
    _card()
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 200000, dtype=np.uint8).tobytes() + DATA
    gpu = zt.compress(data, level=6, chunk_bytes=1 << 16, format="gzip",
                      indexed=True)
    cpu = zt.compress(data, level=6, chunk_bytes=1 << 16, format="gzip",
                      indexed=True, device="cpu")
    assert gpu == cpu
    assert zlib.decompress(gpu, wbits=31) == data
