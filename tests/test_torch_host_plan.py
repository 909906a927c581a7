"""The C host plan (``huffman_host.build_batch_plans`` over
``native.plan_lengths`` and ``native.plan_header``, ``zzt_plan_lengths``
and ``zzt_plan_header`` in ``native/zzflate_native.c``) against the
reference's Python plan it follows (``zzflate_tpu.ops.huffman_host``,
plain numpy), ``build_chunk_plan`` chunk by chunk, on the CPU.

Every key (``ll_len``, ``ll_code``, ``d_len``, ``d_code``, ``hdr_vals``,
``hdr_nbits``, ``eob_v``, ``eob_nb``, with their dtypes, and ``groups``)
is equal on the histograms the encoder plans from the 8 MiB mixed corpus
at levels 1, 6 and 9 (at 9 both the pass-1 plans and the re-plans from the
DP's tokens), with BFINAL on and off and with the fixed codes only, and on
hostile histograms: empty, one literal, no distances, equal weights,
powers of two and Fibonacci weights that force the Kraft repair at 15 bits
for the lit/len code and at 7 bits for the code-length code. A dynamic
header with more fields than a row holds fails in both at the same
group with the same field count.

The corpus histograms are stored in ``data/host_plan_freqs.npz``: making
them takes the CPU analysis of 8 MiB three times (~2.5 min, ~2 GB).
``python tests/test_torch_host_plan.py`` writes them anew from
``zt.compress(mixed_corpus(8 MiB), level, device="cpu")``, and
``test_stored_histograms_are_the_analysis`` holds their first chunk to the
port's analysis."""
import functools
import heapq
from pathlib import Path

import numpy as np
import pytest
import torch

from zzflate_tpu.ops import huffman_host as ref_huffman_host
from zzflate_tpu_torch.ops import huffman_host

# One thread apiece: the test processes share the CPU.
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data" / "host_plan_freqs.npz"
CORPUS_BYTES = 8 << 20
LEVELS = (1, 6, 9)
KEYS = ("ll_len", "ll_code", "d_len", "d_code", "hdr_vals", "hdr_nbits",
        "eob_v", "eob_nb")


def _capture(level: int) -> list:
    """The (B, SB, 318) histograms of every build_batch_plans call of one
    CPU compress of the corpus, in call order."""
    import zzflate_tpu_torch as zt
    from zzflate_tpu_torch.utils.corpus import mixed_corpus

    calls = []
    orig = huffman_host.build_batch_plans

    def spy(freq_ll, freq_d, bfinal, fixed_only=False):
        calls.append(np.concatenate([freq_ll, freq_d], axis=-1))
        return orig(freq_ll, freq_d, bfinal, fixed_only)

    huffman_host.build_batch_plans = spy
    try:
        zt.compress(mixed_corpus(CORPUS_BYTES, 0), level=level,
                    device="cpu")
    finally:
        huffman_host.build_batch_plans = orig
    return calls


@functools.lru_cache(maxsize=None)
def _stored() -> dict:
    """The stored histograms by name, L<level>_<call>."""
    with np.load(DATA) as z:
        return {k: z[k] for k in z.files}


STORED = sorted(_stored()) if DATA.exists() else []


def _assert_same_plans(freq_ll, freq_d, bfinal, fixed_only=False):
    """build_batch_plans equals the reference's build_chunk_plan on every
    chunk."""
    got = huffman_host.build_batch_plans(freq_ll, freq_d, bfinal,
                                         fixed_only=fixed_only)
    assert len(got) == len(freq_ll)
    for j, g in enumerate(got):
        e = ref_huffman_host.build_chunk_plan(freq_ll[j], freq_d[j],
                                              int(bfinal[j]), fixed_only)
        assert g["groups"] == e["groups"], j
        for k in KEYS:
            assert g[k].dtype == e[k].dtype, (j, k)
            np.testing.assert_array_equal(g[k], e[k], err_msg=f"{j} {k}")
    return got


def _huffman_depth(freq) -> int:
    """The deepest leaf of the unlimited Huffman code of freq's non-zero
    weights."""
    heap = [(int(w), 0) for w in freq if w]
    heapq.heapify(heap)
    while len(heap) > 1:
        wa, da = heapq.heappop(heap)
        wb, db = heapq.heappop(heap)
        heapq.heappush(heap, (wa + wb, max(da, db) + 1))
    return heap[0][1] if heap else 0


def _cl_freq(ll_len, d_len):
    """The code-length code's histogram of a dynamic header of these
    lengths, as build_tables counts it."""
    hlit = max(257, int(np.nonzero(ll_len[:286])[0].max()) + 1)
    hdist = max(1, int(np.nonzero(d_len[:30])[0].max()) + 1)
    rle = ref_huffman_host.cl_rle(np.concatenate([ll_len[:hlit],
                                                  d_len[:hdist]]))
    return np.bincount([s for s, _, _ in rle], minlength=19)


# ---------------------------------------------------------------------------
# The corpus' histograms.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixed_only", [False, True],
                         ids=["dynamic", "fixed-only"])
@pytest.mark.parametrize("bfinal", [0, 1], ids=["bfinal-off", "bfinal-on"])
@pytest.mark.parametrize("batch", STORED)
def test_corpus_histograms_plan_as_python(batch, bfinal, fixed_only):
    freqs = _stored()[batch]
    bf = np.full(len(freqs), bfinal)
    got = _assert_same_plans(freqs[..., :288], freqs[..., 288:], bf,
                             fixed_only)
    # Real data: sub-blocks merge, and dynamic blocks win.
    assert sum(len(p["groups"]) for p in got) < freqs.shape[0] * freqs.shape[1]
    btype = [p["hdr_vals"][p["hdr_nbits"][:, 0] > 0, 1] for p in got]
    assert (np.concatenate(btype) == (1 if fixed_only else 2)).all()


def test_stored_histograms_cover_both_passes():
    # Two batches of 16 chunks a level; level 9 re-plans each batch.
    assert STORED == ["L1_0", "L1_1", "L6_0", "L6_1",
                      "L9_0", "L9_1", "L9_2", "L9_3"]
    for k, v in _stored().items():
        assert v.shape == (16, 4, 318), k


@pytest.mark.parametrize("level", LEVELS)
def test_stored_histograms_are_the_analysis(level):
    """The stored first batch's first chunk is the port's analysis of the
    corpus' first 256 KiB chunk."""
    from zzflate_tpu_torch.config import LEVELS as PORT_LEVELS
    from zzflate_tpu_torch.encode_pipeline import build_chunk_batch
    from zzflate_tpu_torch.models import deflate_encoder
    from zzflate_tpu_torch.utils.corpus import mixed_corpus

    data = mixed_corpus(CORPUS_BYTES, 0)[: 1 << 18]
    buf, vends, wstarts, _ = build_chunk_batch(data, 1 << 18, None)
    starts = np.full(1, 32768, np.int32)
    ana = deflate_encoder.analyze_chunks_batch(
        *(torch.as_tensor(a) for a in (buf, starts, vends, wstarts)),
        PORT_LEVELS[level])
    np.testing.assert_array_equal(ana["freqs"].numpy()[0],
                                  _stored()[f"L{level}_0"][0])


# ---------------------------------------------------------------------------
# Hostile histograms.
# ---------------------------------------------------------------------------

def _fib(n):
    out = [1, 1]
    while len(out) < n:
        out.append(out[-1] + out[-2])
    return np.array(out[:n], np.int64)


def _hostile(name):
    """(freq_ll (B, SB, 288), freq_d (B, SB, 30)) of one hostile case."""
    rng = np.random.default_rng(23)
    ll = np.zeros((2, 3, 288), np.int64)
    d = np.zeros((2, 3, 30), np.int64)
    if name == "empty":
        pass
    elif name == "one-literal":
        ll[..., 65] = 1000
    elif name == "eob-only-and-one-distance":
        d[..., 7] = 5
    elif name == "no-distances":
        ll[..., :256] = rng.integers(0, 50, (2, 3, 256))
    elif name == "one-length-one-distance":
        ll[..., 270] = 9
        d[..., 0] = 9
    elif name == "equal-weights":
        ll[..., :286] = 7
        ll[..., 256] = 6  # EOB counts one more
        d[...] = 7
    elif name == "powers-of-two":
        ll[..., :40] = 1 << np.arange(40)
        d[...] = 1 << np.arange(30)
    elif name == "fibonacci":
        ll[..., 100:150] = _fib(50)
        d[...] = _fib(30)
    elif name == "fibonacci-shuffled":
        for j in range(2):
            for b in range(3):
                ll[j, b, rng.permutation(286)[:60]] = _fib(60)
                d[j, b, rng.permutation(30)] = _fib(30)
    elif name == "mixed-rows":
        ll[0, 0, 65] = 3
        ll[0, 1, :286] = 7
        ll[0, 2, :40] = 1 << np.arange(40)
        ll[1, :, :256] = rng.integers(0, 1000, (3, 256))
        d[1, :] = _fib(30)
    elif name == "deep-cl-code":
        ll[...], d[...] = _deep_cl_histograms()
    return ll, d


HOSTILE = ("empty", "one-literal", "eob-only-and-one-distance",
           "no-distances", "one-length-one-distance", "equal-weights",
           "powers-of-two", "fibonacci", "fibonacci-shuffled", "mixed-rows",
           "deep-cl-code")


def _deep_cl_histograms():
    """Dyadic lit/len weights (each symbol's code length is 15 less the
    log of its weight) whose lengths are so skewed that the code-length
    code's Huffman tree is deeper than 7: counts of lengths 7..15 halving
    from 100 symbols at 15 bits, the rest of the Kraft sum in one symbol
    a length, scattered over the alphabet."""
    counts = {15: 100, 14: 50, 13: 25, 12: 12, 11: 6, 10: 3, 9: 2, 8: 1,
              7: 1}
    used = sum(c << (15 - ln) for ln, c in counts.items())
    rest = (1 << 15) - used
    for bit in range(15):
        if rest >> bit & 1:
            counts[15 - bit] = counts.get(15 - bit, 0) + 1
    lengths = np.concatenate([np.full(c, ln) for ln, c in counts.items()])
    rng = np.random.default_rng(5)
    rng.shuffle(lengths)
    syms = np.concatenate([[256], rng.permutation(
        np.setdiff1d(np.arange(286), [256]))[: len(lengths) - 1]])
    ll = np.zeros(288, np.int64)
    ll[syms] = 1 << (15 - lengths)
    ll[256] -= 1  # build_tables counts the EOB once more
    d = np.zeros(30, np.int64)
    d[[3, 9]] = 1
    return ll, d


@pytest.mark.parametrize("fixed_only", [False, True],
                         ids=["dynamic", "fixed-only"])
@pytest.mark.parametrize("name", HOSTILE)
def test_hostile_histograms_plan_as_python(name, fixed_only):
    ll, d = _hostile(name)
    _assert_same_plans(ll, d, np.array([1, 0]), fixed_only)


def test_fibonacci_weights_need_the_repair_at_15_bits():
    """The lit/len cases do reach the Kraft repair: their unlimited codes
    are deeper than 15 bits."""
    for name in ("powers-of-two", "fibonacci", "fibonacci-shuffled"):
        ll, d = _hostile(name)
        assert _huffman_depth(ll[0, 0]) > 15, name
        assert _huffman_depth(d[0, 0]) > 15, name
        t = ref_huffman_host.build_tables(ll[0, 0], d[0, 0], 0)
        assert t["use_dynamic"] and t["ll_len"].max() == 15, name


def test_deep_cl_code_needs_the_repair_at_7_bits():
    ll, d = _deep_cl_histograms()
    t = ref_huffman_host.build_tables(ll, d, 0)
    assert t["use_dynamic"]
    freq_cl = _cl_freq(t["ll_len"], t["d_len"])
    assert _huffman_depth(freq_cl) > 7
    assert ref_huffman_host.code_lengths(freq_cl, 7).max() == 7


def test_header_overflow_raises_the_python_error(monkeypatch):
    """A dynamic header of more fields than a row of hdr_vals holds: both
    stop at the first group that overflows, the reference on its assert of
    the field count, the port with a ValueError that names that count."""
    freqs = _stored()["L6_0"]
    monkeypatch.setattr(huffman_host, "HDR_SLOTS", 40)
    monkeypatch.setattr(ref_huffman_host, "HDR_SLOTS", 40)
    bf = np.zeros(len(freqs), int)
    with pytest.raises(AssertionError) as exp:
        for j in range(len(freqs)):
            ref_huffman_host.build_chunk_plan(freqs[j, :, :288],
                                              freqs[j, :, 288:], 0)
    with pytest.raises(ValueError) as got:
        huffman_host.build_batch_plans(freqs[..., :288], freqs[..., 288:],
                                       bf)
    nfields = exp.value.args[0]
    assert nfields > 40
    assert str(got.value) == f"dynamic header needs {nfields} fields"
    # The fixed codes need two fields: no overflow.
    _assert_same_plans(freqs[..., :288], freqs[..., 288:], bf,
                       fixed_only=True)


def test_batch_plans_are_views_of_batch_arrays():
    freqs = _stored()["L1_0"]
    plans = huffman_host.build_batch_plans(freqs[..., :288],
                                           freqs[..., 288:],
                                           np.zeros(len(freqs), int))
    base = plans[0]["ll_len"].base
    assert base is not None
    assert all(p["ll_len"].base is base for p in plans)
    assert plans[3]["hdr_vals"].shape == (4, huffman_host.HDR_SLOTS)


if __name__ == "__main__":
    DATA.parent.mkdir(exist_ok=True)
    np.savez_compressed(DATA, **{
        f"L{lv}_{i}": f.astype(np.int32)
        for lv in LEVELS for i, f in enumerate(_capture(lv))})
    print(f"wrote {DATA}")
