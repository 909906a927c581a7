"""The level 7-9 optimal parse's card path on the CPU.

``_dp_mirror`` is a scalar mirror of csrc/optimal.cu in its order (per
lane of the warp its class; per sub-block edge the reload; per whole tile
in one sub-block each position's ring read three steps ahead, after the
store of the step that issues it, elsewhere one step at a time; per step
the classes' least cost, the literal against it, the ring store and the
lowest lane at the least cost; per tile the packed words two tiles
ahead): change the two together. It is held to the C DP
(native.optimal_parse, the CPU path's DP) on the seeded batches of
``utils/corpus.optimal_dp_inputs``, and, standing in for the kernel, it
drives ``encode_policy.optimal_override_card`` (parse_rows, the tokens,
the histograms and the re-plan) to the CPU path's override on real
analyses; the pipeline's entry, ``encode_policy.optimal_parse``, runs the
C DP for CPU rows. The kernel itself is held to the C DP by
tests/test_torch_cuda.py on a card. Tolerance is zero: the codec is
integer-only and deterministic.
"""
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from zzflate_tpu_torch import constants as C
from zzflate_tpu_torch import encode_policy, native
from zzflate_tpu_torch.config import LEVELS
from zzflate_tpu_torch.encode_pipeline import build_chunk_batch
from zzflate_tpu_torch.models import deflate_encoder as enc
from zzflate_tpu_torch.ops import huffman_host, kernels
from zzflate_tpu_torch.utils.corpus import (
    OPTIMAL_CASES,
    OPTIMAL_OVERRIDE_CASES,
    optimal_batch_data,
    optimal_dp_inputs,
)

# One thread apiece: the test processes share the CPU (ROADMAP §3).
torch.set_num_threads(1)

M32 = 0xFFFFFFFF
CHUNK = 4096
ROWS = 8  # a batch of optimal_batch_data(CHUNK): 5 chunks, 3 padded rows


def _dist_code(d):
    """The kernel's closed form of the C's distance-code search."""
    x = min(max(int(d), 1), 32768) - 1
    if x < 4:
        return x
    bl = x.bit_length()
    return 2 * (bl - 1) + ((x >> (bl - 2)) & 1)


def _u32(v, absent=30):
    """A code length as the kernel prices it: 0 -> 30 bits, else as u32."""
    return (int(v) & M32) if v else absent


def _dp_mirror(data, mlen, mdist, start, end, lens, bounds):
    """One row's choice (n,) int32, as optimal_dp_kernel computes it."""
    n = len(data)
    out = np.zeros(n, np.int32)
    lo, hi = max(int(start), 0), min(int(end), n)
    if lo >= hi:
        return out
    lanes = range(32)
    cls = [min(ln, 28) for ln in lanes]
    lbase = [int(C.LENGTH_BASE[cls[ln]]) if ln < 29 else 1 << 31
             for ln in lanes]
    top = []
    for ln in lanes:
        c = cls[ln]
        t = (int(C.LENGTH_BASE[c]) + (1 << int(C.LENGTH_EXTRA[c])) - 1
             if c < 28 else 258)
        if c == 27 and t > 257:
            t = 257
        top.append(0 if ln >= 29 else t)
    lext = [int(C.LENGTH_EXTRA[cls[ln]]) for ln in lanes]
    dext = [int(C.DIST_EXTRA[min(ln, 29)]) for ln in lanes]
    # Shared memory starts as garbage that only discarded reads may see.
    ring = np.random.default_rng(5).integers(0, 1 << 32, (512, 32)).tolist()

    def load_raw(tile):
        raw = []
        for ln in lanes:
            pos = tile * 32 + ln
            raw.append((0, 0, 0) if tile < 0 or not lo <= pos < hi else
                       (int(mlen[pos]), int(mdist[pos]), int(data[pos])))
        return raw

    def pack(raw):
        return [b | ((min(m, 258) if m >= 3 else 0) << 8)
                | (_dist_code(d) << 17) for m, d, b in raw]

    st = types.SimpleNamespace(sb=len(bounds) - 2, sb_lo=float("inf"),
                               prev=0, mine=[0] * 32)

    def reload(p):
        while st.sb > 0 and p < bounds[st.sb]:
            st.sb -= 1
        st.sb_lo = int(bounds[st.sb]) if st.sb > 0 else float("-inf")
        row = lens[st.sb]
        st.lit = [_u32(row[k]) for k in range(256)]
        st.lcost = [(_u32(row[257 + cls[ln]]) + lext[ln]) & M32
                    for ln in lanes]
        st.dcost = [(_u32(row[288 + min(ln, 29)]) + dext[ln]) & M32
                    for ln in lanes]

    def word(p, v):
        """The lanes' lengths and flags at p."""
        m = min((v >> 8) & 511, hi - p)
        return [min(m, top[ln]) for ln in lanes], [m >= lbase[ln]
                                                     for ln in lanes]

    def ring_at(p, length):
        return [ring[(p + length[ln]) & 511][ln] for ln in lanes]

    def finish(p, slot, v, length, valid, cr):
        dbits = st.dcost[v >> 17]
        tc = [(st.lcost[ln] + dbits + cr[ln]) & M32 for ln in lanes]
        mc = min(tc[ln] if valid[ln] else M32 for ln in lanes)
        lt = (st.lit[v & 255] + st.prev) & M32
        lit = lt <= mc
        st.prev = lt if lit else mc
        ring[p & 511] = [st.prev] * 32
        at_min = [ln for ln in lanes if valid[ln] and tc[ln] == mc]
        won = length[at_min[0] if at_min else 31]
        st.mine[slot] = 0 if lit else won

    ring[hi & 511] = [0] * 32
    tile = (hi - 1) >> 5
    t_cur, t_nxt = pack(load_raw(tile)), pack(load_raw(tile - 1))
    raw = load_raw(tile - 2)
    p = hi - 1
    while p >= lo:
        base = p & ~31
        whole = False
        if p == base + 31 and base >= lo:
            if p < st.sb_lo:
                reload(p)
            whole = st.sb_lo <= base
        if whole:
            words = [word(base + k, t_cur[k]) for k in range(32)]
            cr = [None] * 32
            for j in (31, 30, 29):
                cr[j] = ring_at(base + j, words[j][0])
            for k in range(31, -1, -1):
                finish(base + k, k, t_cur[k], *words[k], cr[k])
                if k >= 3:
                    cr[k - 3] = ring_at(base + k - 3, words[k - 3][0])
            p = base
        else:
            if p < st.sb_lo:
                reload(p)
            v = t_cur[p & 31]
            length, valid = word(p, v)
            finish(p, p & 31, v, length, valid, ring_at(p, length))
        if (p & 31) == 0 or p == lo:
            for ln in lanes:
                if lo <= base + ln < hi:
                    out[base + ln] = st.mine[ln]
            if (p & 31) == 0:
                t_cur, t_nxt = t_nxt, pack(raw)
                tile = (p >> 5) - 3
                raw = load_raw(tile)
        p -= 1
    return out


def _mirror_batch(data, mlen, mdist, starts, ends, lengths, bounds):
    """kernels.optimal_dp's contract over CPU tensors, by the mirror."""
    a = [t.numpy() for t in (data, mlen, mdist, starts, ends, lengths,
                             bounds)]
    out = np.stack([_dp_mirror(a[0][j], a[1][j], a[2][j], a[3][j], a[4][j],
                               a[5][j], a[6])
                    for j in range(a[0].shape[0])])
    return torch.from_numpy(out)


@pytest.mark.parametrize("case", OPTIMAL_CASES)
def test_mirror_equals_the_c_dp(case):
    data, mlen, mdist, starts, ends, lengths, bounds = optimal_dp_inputs(case)
    for j in range(data.shape[0]):
        choice = _dp_mirror(data[j], mlen[j], mdist[j], starts[j], ends[j],
                            lengths[j], bounds)
        assert not choice[: max(starts[j], 0)].any()
        assert not choice[ends[j]:].any()
        exp = native.optimal_parse(
            data[j], mlen[j], mdist[j], starts[j], ends[j],
            lengths[j, :, :288], lengths[j, :, 288:], bounds)
        got = chip_smoke.dp_walk(choice, starts[j], ends[j])
        for g, e, name in zip(got, exp, ("committed", "take", "sel_len")):
            np.testing.assert_array_equal(g, e, err_msg=f"row {j} {name}")


def _analysis(data, level, **kw):
    """A batch of ROWS rows of `data` at `level` (padded as the pipeline
    pads), its CPU analysis and pass-1 plans."""
    buf, vends, wstarts, nchunks = build_chunk_batch(data, CHUNK, None)
    pad = ROWS - nchunks
    buf = np.concatenate([buf, np.zeros((pad, buf.shape[1]), np.uint8)])
    vends = np.concatenate([vends, np.full(pad, 32768, np.int32)])
    wstarts = np.concatenate([wstarts, np.full(pad, 32768, np.int32)])
    starts = np.full(ROWS, 32768, np.int32)
    rows = [torch.as_tensor(a) for a in (buf, starts, vends, wstarts)]
    ana = enc.analyze_chunks_batch(*rows, LEVELS[level], **kw)
    freqs = ana["freqs"].numpy()
    fixed_only = kw.get("strategy") == 4

    def pass1():
        return [huffman_host.build_chunk_plan(
            freqs[j, :, :288], freqs[j, :, 288:],
            bfinal=int(j == nchunks - 1), fixed_only=fixed_only)
            for j in range(ROWS)]
    ctx = types.SimpleNamespace(nchunks=nchunks, fixed_only=fixed_only,
                                stream_final=True)
    return ctx, ana, rows, buf, vends, pass1


@pytest.mark.parametrize("case", list(OPTIMAL_OVERRIDE_CASES))
def test_card_override_equals_cpu_path(case, monkeypatch):
    """optimal_override_card, with the mirror for the kernel, gives the C
    path's override arrays, plans and largest token count on a batch with
    a zero chunk, a periodic one, a short last one and padded rows."""
    level, kw = OPTIMAL_OVERRIDE_CASES[case]
    ctx, ana, rows, buf, vends, pass1 = _analysis(
        optimal_batch_data(CHUNK), level, **kw)
    exp_plans = pass1()
    exp, exp_ntok = encode_policy.optimal_override(
        ctx, exp_plans, ana, ana["mm_packed"].numpy(), buf, vends, 0)
    monkeypatch.setattr(kernels, "optimal_dp", _mirror_batch)
    plans = pass1()
    got, ntok = encode_policy.optimal_override_card(
        ctx, plans, ana, tuple(rows[:3]), 0)
    assert ntok == exp_ntok
    for k, e in exp.items():
        assert got[k].dtype == e.dtype, k
        assert torch.equal(got[k], e), k
    for p, e in zip(plans, exp_plans):
        for k in e:
            if k == "groups":
                assert p[k] == e[k]
            else:
                np.testing.assert_array_equal(p[k], e[k], err_msg=k)


@pytest.mark.parametrize("case", list(OPTIMAL_OVERRIDE_CASES))
def test_optimal_parse_on_the_cpu_runs_the_c_dp(case, monkeypatch):
    """The pipeline's entry (encode_policy.optimal_parse) on CPU rows runs
    the C DP over the analysis' packed candidates and never the kernel:
    the same override arrays, plans and token count as optimal_override."""
    level, kw = OPTIMAL_OVERRIDE_CASES[case]
    ctx, ana, rows, buf, vends, pass1 = _analysis(
        optimal_batch_data(CHUNK), level, **kw)
    exp_plans = pass1()
    exp, exp_ntok = encode_policy.optimal_override(
        ctx, exp_plans, ana, ana["mm_packed"].numpy(), buf, vends, 0)

    def no_kernel(*args):
        raise AssertionError("optimal_dp called for CPU rows")
    monkeypatch.setattr(kernels, "optimal_dp", no_kernel)
    plans = pass1()
    got, ntok = encode_policy.optimal_parse(ctx, plans, ana,
                                            tuple(rows[:3]), 0)
    assert ntok == exp_ntok
    assert got.keys() == exp.keys()
    for k, e in exp.items():
        assert got[k].dtype == e.dtype, k
        assert torch.equal(got[k], e), k
    for p, e in zip(plans, exp_plans):
        assert p.keys() == e.keys()
        for k in e:
            if k == "groups":
                assert p[k] == e[k]
            else:
                np.testing.assert_array_equal(p[k], e[k], err_msg=k)


def _dp_args(**over):
    data, mlen, mdist, starts, ends, lengths, bounds = optimal_dp_inputs(
        "random", n=256)
    args = dict(data=torch.from_numpy(data), mlen=torch.from_numpy(mlen),
                mdist=torch.from_numpy(mdist),
                starts=torch.from_numpy(starts), ends=torch.from_numpy(ends),
                lengths=torch.from_numpy(lengths),
                bounds=torch.from_numpy(bounds))
    args.update(over)
    return args


def test_optimal_dp_raises_on_a_cpu_tensor():
    """The kernel has no CPU version: the CPU path runs the C DP."""
    with pytest.raises(ValueError, match="CUDA"):
        kernels.optimal_dp(**_dp_args())


@pytest.mark.parametrize("bad", [
    "mlen-short", "mdist-wide", "starts-long", "ends-2d", "lengths-width",
    "lengths-rows", "bounds-sub-blocks", "data-int32", "mlen-int64",
])
def test_optimal_dp_rejects_shapes_that_disagree(bad):
    """Shapes and types are checked before any pointer reaches the card."""
    a = _dp_args()
    over = {
        "mlen-short": dict(mlen=a["mlen"][:, :-1].contiguous()),
        "mdist-wide": dict(mdist=torch.zeros((4, 257), dtype=torch.int32)),
        "starts-long": dict(starts=torch.zeros(5, dtype=torch.int32)),
        "ends-2d": dict(ends=a["ends"][None]),
        "lengths-width": dict(lengths=a["lengths"][..., :317].contiguous()),
        "lengths-rows": dict(lengths=a["lengths"][:3].contiguous()),
        "bounds-sub-blocks": dict(bounds=a["bounds"][:-1].contiguous()),
        "data-int32": dict(data=a["data"].int()),
        "mlen-int64": dict(mlen=a["mlen"].long()),
    }[bad]
    with pytest.raises((ValueError, TypeError)) as err:
        kernels.optimal_dp(**_dp_args(**over))
    assert "CUDA" not in str(err.value)


def test_optimal_ring_matches_kernels_header():
    src = (Path(kernels.__file__).resolve().parent.parent / "csrc"
           / "kernels.h").read_text()
    m = re.search(r"#define ZZ_OPT_RING (\d+)", src)
    assert int(m.group(1)) == kernels.OPT_RING
    assert kernels.OPT_RING > C.MAX_MATCH + 1
    assert kernels.OPT_RING & (kernels.OPT_RING - 1) == 0
