"""Levels 7-9 of zzflate_tpu_torch against zzflate_tpu, on the CPU.

The reference takes the C shortest-bit-path DP only when its C library
is built, and otherwise the lazy parse without a word; every comparison
here first asserts that library, so it holds the port to the DP's bytes.
Stages: the C DP itself (the port's copy against the reference's), the
override that re-plans a batch from its tokens, and compress() end to
end, whose output must also decode with stdlib zlib. Tolerance is zero:
the codec is integer-only and deterministic.
"""
import types
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import zzflate_tpu as zf
import zzflate_tpu_torch as zt
from zzflate_tpu import encode_policy as jax_policy
from zzflate_tpu import native as jax_native
from zzflate_tpu.config import LEVELS as JAX_LEVELS
from zzflate_tpu.models import deflate_encoder as jax_enc
from zzflate_tpu.ops import huffman_host as jax_huffman_host
from zzflate_tpu_torch import encode_policy, native
from zzflate_tpu_torch.encode_pipeline import build_chunk_batch
from zzflate_tpu_torch.ops import huffman_host
from zzflate_tpu_torch.utils.corpus import mixed_corpus

# The test processes share the CPU. With torch's default intra-op pool in
# each of them it is oversubscribed, and a CPU-path call runs tens of
# times slower; one thread apiece keeps the suite inside its time limit.
torch.set_num_threads(1)

CHUNK = 4096
DATA = mixed_corpus(20000, 31)
DICT = mixed_corpus(6000, 32)[-5000:]

CASES = {
    "zlib": dict(),
    "gzip": dict(format="gzip"),
    "raw": dict(format="raw"),
    "dictionary": dict(dictionary=DICT),
    "window-bits-9": dict(window_bits=9),
    "filtered": dict(strategy=1),
    "huffman-only": dict(strategy=2),
    "rle": dict(strategy=3),
    "fixed": dict(strategy=4),
    "indexed": dict(format="gzip", indexed=True),
    "seekable": dict(format="gzip", indexed=True, seekable=True),
}


@pytest.fixture(autouse=True, scope="module")
def _reference_takes_the_dp():
    """Without its C library the reference silently keeps the lazy parse,
    and equal bytes would prove nothing."""
    assert jax_native.lib() is not None


def _decode(out, kw):
    fmt = kw.get("format", "zlib")
    if fmt == "raw":
        return zlib.decompress(out, wbits=-15)
    if fmt == "gzip":
        return zlib.decompress(out, wbits=31)
    wbits = kw.get("window_bits", 15)
    d = (zlib.decompressobj(wbits, zdict=kw["dictionary"])
         if "dictionary" in kw else zlib.decompressobj(wbits))
    return d.decompress(out) + d.flush()


def _same_bytes(data, level, chunk_bytes=CHUNK, **kw):
    exp = zf.compress(data, level=level, chunk_bytes=chunk_bytes, **kw)
    got = zt.compress(data, level=level, chunk_bytes=chunk_bytes,
                      device="cpu", **kw)
    assert got == exp
    assert _decode(got, kw) == data
    return got


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("level", [7, 8, 9], ids=["L7", "L8", "L9"])
def test_compress_equals_reference(level, case):
    _same_bytes(DATA, level, **CASES[case])


@pytest.mark.parametrize(
    "data, kw",
    [(b"", {}), (b"x", {}), (mixed_corpus(70000, 33), {"mem_level": 2})],
    ids=["empty", "one-byte", "70000-two-batches"],
)
@pytest.mark.parametrize("level", [7, 9], ids=["L7", "L9"])
def test_corner_inputs_equal_reference(level, data, kw):
    _same_bytes(data, level, **kw)


def test_window_bits_bound_the_dp_distances():
    """window_bits=9 at L9: the analysis drops far matches before the DP
    sees them, so every distance the DP takes fits 512 bytes."""
    from zzflate_tpu_torch.config import LEVELS
    from zzflate_tpu_torch.models import deflate_encoder as enc

    buf, vends, wstarts, nchunks = build_chunk_batch(DATA, CHUNK, None)
    starts = np.full(nchunks, 32768, np.int32)
    ana = enc.analyze_chunks_batch(
        *(torch.as_tensor(a) for a in (buf, starts, vends, wstarts)),
        LEVELS[9], max_dist=512,
    )
    freqs = ana["freqs"].numpy()
    plans = huffman_host.build_batch_plans(freqs[..., :288],
                                           freqs[..., 288:], [0] * nchunks)
    ctx = types.SimpleNamespace(nchunks=nchunks, fixed_only=False,
                                stream_final=True, device=torch.device("cpu"))
    got, _ = encode_policy.optimal_override(
        ctx, plans, ana, ana["mm_packed"].numpy(), buf, vends, 0)
    dist = ana["mdist"][got["is_match"]]
    assert dist.numel() > 100
    assert int(dist.max()) <= 512 and int(dist.min()) >= 1


# ---------------------------------------------------------------------------
# The C DP: the port's copy against the reference's.
# ---------------------------------------------------------------------------

# name: (n, start, end, sub-blocks, lengths, zero-length share)
DP_CASES = {
    "random": (3000, 100, 2900, 3, "random", 0.0),
    "lengths-past-end": (2000, 0, 2000, 1, "long", 0.0),
    "lengths-257-258": (3000, 0, 3000, 2, "edge", 0.0),
    "absent-symbols": (3000, 50, 3000, 3, "random", 0.6),
    "all-absent": (1500, 0, 1500, 2, "random", 1.0),
    "many-sub-blocks": (4000, 10, 3990, 7, "random", 0.2),
    "start-equals-end": (1000, 400, 400, 1, "random", 0.0),
}


def _dp_input(name):
    n, start, end, nsb, kind, zero = DP_CASES[name]
    rng = np.random.default_rng(list(DP_CASES).index(name))
    data = rng.integers(0, 256, n).astype(np.uint8)
    if kind == "long":
        mlen = rng.integers(3, 259, n)
        mlen[-300:] = 258  # reaches past end - i
    elif kind == "edge":
        mlen = rng.choice([0, 3, 256, 257, 258], n)
    else:
        mlen = np.where(rng.random(n) < 0.5, rng.integers(3, 259, n), 0)
    mdist = np.where(mlen > 0, rng.integers(1, 32769, n), 0)
    ll = rng.integers(1, 16, (nsb, 288))
    dd = rng.integers(1, 16, (nsb, 30))
    ll[rng.random((nsb, 288)) < zero] = 0
    dd[rng.random((nsb, 30)) < zero] = 0
    bounds = [start + (b * (end - start)) // nsb for b in range(nsb)] + [end]
    return (data, mlen.astype(np.int32), mdist.astype(np.int32), start, end,
            ll.astype(np.int32), dd.astype(np.int32), bounds)


@pytest.mark.parametrize("case", list(DP_CASES))
def test_optimal_parse_equals_reference(case):
    args = _dp_input(case)
    got = native.optimal_parse(*args)
    exp = jax_native.optimal_parse(*args)
    for g, e, name in zip(got, exp, ("committed", "take", "sel_len")):
        np.testing.assert_array_equal(g, e, err_msg=name)
    com, take, sel = got
    _, mlen, _, start, end, *_ = args
    # The tokens tile [start, end) and each length is one the matcher
    # found (or a shorter one).
    covered = np.where(take, sel, com.astype(np.int32))
    assert covered.sum() == end - start
    assert (sel[take] >= 3).all() and (sel[take] <= mlen[take]).all()


def test_optimal_parse_rejects_mismatched_shapes():
    """Shapes are checked before any pointer reaches the C code."""
    data, mlen, mdist, start, end, ll, dd, bounds = _dp_input("random")
    for bad in ((data, mlen[:-1], mdist, start, end, ll, dd, bounds),
                (data, mlen, mdist, start, end, ll[:, :287], dd, bounds),
                (data, mlen, mdist, start, end, ll, dd[:1], bounds),
                (data, mlen, mdist, start, end, ll, dd, bounds[:-1])):
        with pytest.raises(ValueError):
            native.optimal_parse(*bad)


# ---------------------------------------------------------------------------
# The override: the DP over a batch, and the plans rebuilt from its tokens.
# ---------------------------------------------------------------------------

_OVERRIDE_KEYS = ("committed", "is_match", "litlen_sym", "lcode", "mlen")
_PLAN_KEYS = ("ll_len", "ll_code", "d_len", "d_code", "hdr_vals",
              "hdr_nbits", "eob_v", "eob_nb")


# Rows per batch: the compress cases' batch (5 chunks of DATA round up to
# 8), so the reference's analysis reuses their compiled graph.
ROWS = 8


@pytest.mark.parametrize(
    "fixed_only, nreal", [(False, ROWS), (True, ROWS), (False, 5)],
    ids=["dynamic", "fixed-only", "padded-rows"],
)
def test_optimal_override_equals_reference(fixed_only, nreal):
    """From the reference's own L9 analysis of a batch (with nreal real
    chunks, the rest padding), both overrides give the same arrays,
    plans and largest token count."""
    data = mixed_corpus(CHUNK * nreal - 700, 35)
    buf, vends, wstarts, _ = build_chunk_batch(data, CHUNK, dictionary=None)
    pad = ROWS - nreal
    buf = np.concatenate([buf, np.zeros((pad, buf.shape[1]), np.uint8)])
    vends = np.concatenate([vends, np.full(pad, 32768, np.int32)])
    wstarts = np.concatenate([wstarts, np.full(pad, 32768, np.int32)])
    starts = np.full(ROWS, 32768, np.int32)
    ana = jax_enc.analyze_chunks_batch(
        jnp.asarray(buf), jnp.asarray(starts), jnp.asarray(vends),
        jnp.asarray(wstarts), JAX_LEVELS[9], huffman_only=False,
        with_checksums=False, strategy=0, max_dist=32768,
    )
    freqs = np.asarray(ana["freqs"])
    bfinals = np.array([int(j == nreal - 1) for j in range(ROWS)])

    ref_ctx = types.SimpleNamespace(bsz=ROWS, fixed_only=fixed_only,
                                    single_block_chunks=False, sharding=None)
    ref_plans = [jax_huffman_host.build_chunk_plan(
        freqs[j, :, :288], freqs[j, :, 288:], bfinal=int(bfinals[j]),
        fixed_only=fixed_only) for j in range(ROWS)]
    # The port's pass 1 is its C batch plan, equal to the reference's.
    plans = huffman_host.build_batch_plans(
        freqs[..., :288], freqs[..., 288:], bfinals, fixed_only=fixed_only)
    for p, e in zip(plans, ref_plans):
        for k in _PLAN_KEYS:
            np.testing.assert_array_equal(p[k], e[k], err_msg=k)
        assert p["groups"] == e["groups"]
    ref_ana = dict(ana, _host_buf=buf, _host_valid_ends=vends)
    exp, exp_ntok = jax_policy.optimal_override(ref_ctx, ref_plans, ref_ana,
                                                bfinals, 0, nreal)
    ctx = types.SimpleNamespace(nchunks=nreal, fixed_only=fixed_only,
                                stream_final=True, device=torch.device("cpu"))
    port_ana = {k: torch.as_tensor(np.array(ana[k]))
                for k in ("dcode", "mdist")}
    got, ntok = encode_policy.optimal_override(
        ctx, plans, port_ana, np.asarray(ana["mm_packed"]), buf, vends, 0)
    assert ntok == exp_ntok
    for k in _OVERRIDE_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(exp[k]),
                                      err_msg=k)
    assert got["committed"].dtype == torch.bool
    assert got["mlen"].dtype == torch.int32
    for p, e in zip(plans, ref_plans):
        for k in _PLAN_KEYS:
            np.testing.assert_array_equal(np.asarray(p[k]), np.asarray(e[k]),
                                          err_msg=k)
        assert p["groups"] == e["groups"]
    # The DP emits more tokens than the lazy parse on this data: the
    # compact emit's budget must take its count.
    assert ntok > int(freqs[:, :, :288].sum(axis=(1, 2)).max())
