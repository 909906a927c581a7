"""The port's two-phase encoder against the JAX package's, on the CPU.

Phase 1 (analyze_chunks_batch): every key of the output dict is equal
(at levels 7-9 also mm_packed, the DP's packed candidates).
The plans: the port's C batch plan (huffman_host.build_batch_plans)
equals the reference's build_chunk_plan on every key of that analysis.
Phase 2 (emit_chunks_batch): fed the JAX analysis through
zzflate_tpu_torch.interop, so a mismatch is the emit's alone; compact
and full-width, with and without anchors, with one and with two
sub-blocks per chunk. Tolerance is zero: the codec is integer-only and
deterministic.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zzflate_tpu.config import LEVELS as JAX_LEVELS
from zzflate_tpu.models import deflate_encoder as jax_enc
from zzflate_tpu.ops import huffman_host as jax_huffman_host
from zzflate_tpu_torch import interop
from zzflate_tpu_torch.encode_pipeline import build_chunk_batch
from zzflate_tpu_torch.models import deflate_encoder as enc
from zzflate_tpu_torch.ops import huffman_host
from zzflate_tpu_torch.utils.corpus import mixed_corpus

# The test processes share the CPU. With torch's default intra-op pool in
# each of them it is oversubscribed, and a CPU-path call runs tens of
# times slower; one thread apiece keeps the suite inside its time limit.
torch.set_num_threads(1)

_KEYS = ("freq_ll", "freq_d", "freqs", "committed", "is_match",
         "litlen_sym", "lcode", "dcode", "mlen", "mdist")


def _batch(chunk_bytes, nchunks, seed):
    data = mixed_corpus(chunk_bytes * nchunks - 1000, seed)
    buf, vends, wstarts, _ = build_chunk_batch(data, chunk_bytes,
                                               dictionary=data[:3000])
    starts = np.full(nchunks, 32768, np.int32)
    return buf, starts, vends, wstarts


def _jax_analysis(level, buf, starts, vends, wstarts, **kw):
    ana = jax_enc.analyze_chunks_batch(
        jnp.asarray(buf), jnp.asarray(starts), jnp.asarray(vends),
        jnp.asarray(wstarts), JAX_LEVELS[level], **kw,
    )
    return {k: np.asarray(ana[k]) for k in _KEYS + ("mm_packed",)
            if k in ana}


@pytest.fixture(scope="module")
def small():
    return _batch(4096, 4, seed=21)


@pytest.fixture(scope="module")
def ref_l6(small):
    return _jax_analysis(6, *small)


def _params(level):
    return interop.level_params_from_dict(
        dataclasses.asdict(JAX_LEVELS[level])
    )


@pytest.mark.parametrize(
    "level, kw",
    [(6, {}), (1, {}), (1, {"strategy": 3}), (1, {"max_dist": 512}),
     (1, {"huffman_only": True}), (9, {})],
    ids=["L6", "L1", "L1-rle", "L1-wbits9", "L1-huffman-only", "L9"],
)
def test_analyze_equals_reference(small, ref_l6, level, kw):
    exp = ref_l6 if (level, kw) == (6, {}) else _jax_analysis(level, *small,
                                                              **kw)
    buf, starts, vends, wstarts = (torch.as_tensor(a) for a in small)
    got = enc.analyze_chunks_batch(buf, starts, vends, wstarts,
                                   _params(level), **kw)
    assert set(got) == set(exp)
    assert ("mm_packed" in got) == (level == 9)
    for k in exp:
        np.testing.assert_array_equal(got[k].numpy(), exp[k], err_msg=k)


_PLAN_KEYS = ("ll_len", "ll_code", "d_len", "d_code", "hdr_vals",
              "hdr_nbits", "eob_v", "eob_nb")


def _plans(ana, nchunks):
    """The reference's plans (build_chunk_plan a chunk) and the port's
    (build_batch_plans, the C plan, for the batch), held equal on every
    key."""
    freqs = ana["freqs"]
    bfinal = [int(j == nchunks - 1) for j in range(nchunks)]
    ref = [
        jax_huffman_host.build_chunk_plan(
            freqs[j, :, :288], freqs[j, :, 288:], bfinal=bfinal[j],
        )
        for j in range(nchunks)
    ]
    port = huffman_host.build_batch_plans(
        freqs[:nchunks, :, :288], freqs[:nchunks, :, 288:], bfinal)
    for p, e in zip(port, ref, strict=True):
        assert p["groups"] == e["groups"]
        for k in _PLAN_KEYS:
            np.testing.assert_array_equal(p[k], e[k], err_msg=k)
    return ref, port


def _emit_both(ana, plans, chunk_bytes, with_anchors, compact_tokens):
    """plans: _plans' pair; the reference emits from its own, the port
    from the C plan."""
    ref_plans, port_plans = plans
    out_words = enc.output_words_bound(chunk_bytes)
    slots = enc.token_budget(chunk_bytes) if compact_tokens else 0
    tables = {k: np.stack([p[k] for p in ref_plans]) for k in _PLAN_KEYS}
    kbm = np.full(len(ref_plans), 8 * chunk_bytes, np.int32)
    exp = jax_enc.emit_chunks_batch(
        {k: jnp.asarray(v) for k, v in ana.items()}, out_words,
        *(jnp.asarray(tables[k]) for k in _PLAN_KEYS),
        keep_bits_max=jnp.asarray(kbm), with_anchors=with_anchors,
        compact=True, token_slots=slots,
    )
    t = interop.plan_stack(port_plans, "cpu")
    got = enc.emit_chunks_batch(
        interop.analysis_from_numpy(ana, "cpu"), out_words,
        t["ll_len"], t["ll_code"], t["d_len"], t["d_code"], t["hdr_vals"],
        t["hdr_nbits"], t["eob_v"], t["eob_nb"],
        keep_bits_max=torch.as_tensor(kbm), with_anchors=with_anchors,
        token_slots=slots,
    )
    np.testing.assert_array_equal(got["meta"].numpy(), np.asarray(exp["meta"]))
    np.testing.assert_array_equal(got["word_cnt"].numpy(),
                                  np.asarray(exp["word_cnt"]))
    np.testing.assert_array_equal(got["flat_words"].numpy().view(np.uint32),
                                  np.asarray(exp["flat_words"]))
    return got


@pytest.mark.parametrize("with_anchors", [False, True],
                         ids=["plain", "anchors"])
@pytest.mark.parametrize("compact_tokens", [True, False],
                         ids=["compact", "full-width"])
def test_emit_equals_reference(ref_l6, compact_tokens, with_anchors):
    got = _emit_both(ref_l6, _plans(ref_l6, 4), 4096, with_anchors,
                     compact_tokens)
    assert int(got["word_cnt"].sum()) > 0
    if with_anchors:
        assert (got["anc_bit"] >= 0).any()


def test_emit_two_sub_blocks_equals_reference():
    """128 KiB chunks: two sub-blocks per chunk, so the per-sub-block
    offsets, merged groups and anchor slots all take part."""
    batch = _batch(1 << 17, 2, seed=22)
    ana = _jax_analysis(1, *batch)
    plans = _plans(ana, 2)
    got = _emit_both(ana, plans, 1 << 17, True, True)
    assert got["sb_bits"].shape[1] == 2


def test_closed_form_code_math_matches_tables():
    """The port's bit-length code math against its own RFC 1951 tables
    (which equal the reference's)."""
    from zzflate_tpu_torch import constants as C

    lengths = torch.arange(3, 259)
    lcode = enc._len_code(lengths)
    np.testing.assert_array_equal(lcode.numpy(), C.LENGTH_TO_CODE[3:])
    ext, base = enc._len_extra_base(lcode)
    np.testing.assert_array_equal(ext.numpy(), C.LENGTH_EXTRA[lcode.numpy()])
    np.testing.assert_array_equal(base.numpy(), C.LENGTH_BASE[lcode.numpy()])
    dists = torch.arange(1, 32769)
    dcode = enc._dist_code(dists)
    np.testing.assert_array_equal(
        dcode.numpy(), [C.dist_to_code(d) for d in range(1, 32769)]
    )
    ext, base = enc._dist_extra_base(dcode)
    np.testing.assert_array_equal(ext.numpy(), C.DIST_EXTRA[dcode.numpy()])
    np.testing.assert_array_equal(base.numpy(), C.DIST_BASE[dcode.numpy()])
