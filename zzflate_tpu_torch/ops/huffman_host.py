"""Host-side Huffman table + dynamic-header construction (numpy).

The port's own copy of ``zzflate_tpu/ops/huffman_host.py``. The per-block
tree build is O(288 log 288) scalar work; it runs on the host between
the device analyze and emit phases (models/deflate_encoder.py).
"""
from __future__ import annotations

import heapq

import numpy as np

from zzflate_tpu_torch import constants as C

HDR_SLOTS = 672


def code_lengths(freq: np.ndarray, max_len: int) -> np.ndarray:
    """Optimal-then-repaired length-limited code lengths."""
    freq = np.asarray(freq, np.int64)
    n = freq.size
    syms = np.nonzero(freq)[0]
    lengths = np.zeros(n, np.int32)
    if syms.size == 0:
        return lengths
    if syms.size == 1:
        lengths[syms[0]] = 1
        return lengths

    # Huffman depths via a heap of (weight, tiebreak, id); children tracked
    # to assign depths top-down afterwards.
    heap = [(int(freq[s]), i, i) for i, s in enumerate(syms)]
    heapq.heapify(heap)
    children: list[tuple[int, int]] = []  # node id - n_leaves -> (a, b)
    nxt = syms.size
    while len(heap) > 1:
        wa, _, a = heapq.heappop(heap)
        wb, _, b = heapq.heappop(heap)
        children.append((a, b))
        heapq.heappush(heap, (wa + wb, nxt, nxt))
        nxt += 1
    depth = np.zeros(nxt, np.int32)
    for node in range(nxt - 1, syms.size - 1, -1):
        a, b = children[node - syms.size]
        depth[a] = depth[node] + 1
        depth[b] = depth[node] + 1
    leaf_depth = depth[: syms.size]

    # Depth-limit repair on the clamped multiset, driven by the exact
    # integer Kraft sum (units of 2^-max_len).
    clamped = np.minimum(leaf_depth, max_len)
    bl_count = np.bincount(clamped, minlength=max_len + 1)
    kraft = int((1 << (max_len - clamped)).sum())
    full = 1 << max_len
    while kraft > full:
        bits = max(
            l for l in range(1, max_len) if bl_count[l] > 0
        )
        bl_count[bits] -= 1
        bl_count[bits + 1] += 2
        bl_count[max_len] -= 1
        kraft -= 1

    # Redistribute: leaves sorted by (freq asc, sym asc) take the length
    # multiset in descending order.
    order = np.lexsort((syms, freq[syms]))
    assign = np.repeat(
        np.arange(max_len, 0, -1),
        bl_count[max_len:0:-1],
    )
    lengths[syms[order]] = assign
    return lengths


def canonical_codes_lsb(lengths: np.ndarray) -> np.ndarray:
    """Canonical codes, bit-reversed for LSB-first emission."""
    codes = C.canonical_codes(lengths)
    return C.bit_reverse(codes, lengths).astype(np.uint32)


def cl_rle(combined: np.ndarray) -> list[tuple[int, int, int]]:
    """RFC 1951 3.2.7 RLE of the transmitted lengths.

    Returns [(symbol, extra_val, extra_bits), ...]."""
    out = []
    n = len(combined)
    i = 0
    prev = -1
    while i < n:
        cur = int(combined[i])
        run = 1
        while i + run < n and int(combined[i + run]) == cur:
            run += 1
        if cur == 0:
            left = run
            while left >= 11:
                r = min(left, 138)
                out.append((18, r - 11, 7))
                left -= r
            while left >= 3:
                r = min(left, 10)
                out.append((17, r - 3, 3))
                left -= r
            while left:
                out.append((0, 0, 0))
                left -= 1
        else:
            left = run
            if cur != prev:
                out.append((cur, 0, 0))
                left -= 1
            while left >= 3:
                r = min(left, 6)
                out.append((16, r - 3, 2))
                left -= r
            while left:
                out.append((cur, 0, 0))
                left -= 1
        prev = cur
        i += run
    return out


def _entropy_bits(freq: np.ndarray) -> float:
    t = freq.sum()
    if t == 0:
        return 0.0
    nz = freq[freq > 0].astype(np.float64)
    return float((nz * np.log2(t / nz)).sum())


_HDR_EST_BITS = 700  # typical dynamic header size


def plan_block_groups(
    freq_ll: np.ndarray, freq_d: np.ndarray
) -> list[list[int]]:
    """Adaptive block segmentation: greedy left-to-right merge of adjacent
    sub-blocks while the entropy estimate of the merged histograms beats
    two trees plus an extra header."""
    sb = freq_ll.shape[0]
    groups = [[0]]
    acc_ll = freq_ll[0].astype(np.int64).copy()
    acc_d = freq_d[0].astype(np.int64).copy()
    for b in range(1, sb):
        c_sep = (
            _entropy_bits(acc_ll) + _entropy_bits(acc_d)
            + _entropy_bits(freq_ll[b]) + _entropy_bits(freq_d[b])
            + 2 * _HDR_EST_BITS
        )
        m_ll = acc_ll + freq_ll[b]
        m_d = acc_d + freq_d[b]
        c_mrg = _entropy_bits(m_ll) + _entropy_bits(m_d) + _HDR_EST_BITS
        if c_mrg <= c_sep:
            groups[-1].append(b)
            acc_ll, acc_d = m_ll, m_d
        else:
            groups.append([b])
            acc_ll = freq_ll[b].astype(np.int64).copy()
            acc_d = freq_d[b].astype(np.int64).copy()
    return groups


def build_chunk_plan(
    freq_ll: np.ndarray,
    freq_d: np.ndarray,
    bfinal: int,
    fixed_only: bool = False,
):
    """Per-sub-block table/header arrays for one chunk (SB sub-blocks).

    Adjacent sub-blocks with similar statistics share one deflate block:
    the group's header rides the first sub-block (hdr widths 0 on the
    rest), its EOB the last. Returns dict of (SB, ...) arrays:
    ll_len/ll_code (SB,288), d_len/d_code (SB,30),
    hdr_vals/hdr_nbits (SB,HDR_SLOTS), eob_v/eob_nb (SB,), and "groups".
    """
    sb = freq_ll.shape[0]
    groups = plan_block_groups(freq_ll, freq_d)
    out = {
        "ll_len": np.zeros((sb, 288), np.int32),
        "ll_code": np.zeros((sb, 288), np.uint32),
        "d_len": np.zeros((sb, 30), np.int32),
        "d_code": np.zeros((sb, 30), np.uint32),
        "hdr_vals": np.zeros((sb, HDR_SLOTS), np.uint32),
        "hdr_nbits": np.zeros((sb, HDR_SLOTS), np.int32),
        "eob_v": np.zeros((sb,), np.uint32),
        "eob_nb": np.zeros((sb,), np.int32),
    }
    for g, members in enumerate(groups):
        is_last_group = g == len(groups) - 1
        t = build_tables(
            freq_ll[members].sum(axis=0),
            freq_d[members].sum(axis=0),
            bfinal=bfinal if is_last_group else 0,
            fixed_only=fixed_only,
        )
        for m in members:
            out["ll_len"][m] = t["ll_len"]
            out["ll_code"][m] = t["ll_code"]
            out["d_len"][m] = t["d_len"]
            out["d_code"][m] = t["d_code"]
        first, last = members[0], members[-1]
        out["hdr_vals"][first] = t["hdr_vals"]
        out["hdr_nbits"][first] = t["hdr_nbits"]
        out["eob_v"][last] = t["ll_code"][C.END_OF_BLOCK]
        out["eob_nb"][last] = t["ll_len"][C.END_OF_BLOCK]
    out["groups"] = groups
    return out


def build_tables(
    freq_ll: np.ndarray,
    freq_d: np.ndarray,
    bfinal: int,
    fixed_only: bool = False,
):
    """Code tables + header field stream for one block.

    freq_ll must NOT yet include the end-of-block symbol; forcing rules
    (>=2 used lit/len symbols, >=2 distance codes) are applied here so the
    emitted trees are always complete and decoder-friendly.
    """
    freq_ll = np.asarray(freq_ll, np.int64).copy()
    freq_d = np.asarray(freq_d, np.int64).copy()
    freq_ll[C.END_OF_BLOCK] += 1
    if (freq_ll > 0).sum() < 2:
        freq_ll[0] = max(freq_ll[0], 1)
    if (freq_d > 0).sum() < 1:
        freq_d[0] = 1
    if (freq_d > 0).sum() < 2:
        freq_d[1 if freq_d[0] > 0 else 0] = max(
            freq_d[1 if freq_d[0] > 0 else 0], 1
        )

    ll_len_fix = C.fixed_litlen_lengths()
    d_len_fix = C.fixed_dist_lengths()
    body_fix = int((freq_ll * ll_len_fix).sum() + (freq_d * d_len_fix).sum())

    hdr_vals = np.zeros(HDR_SLOTS, np.uint32)
    hdr_nbits = np.zeros(HDR_SLOTS, np.int32)

    use_dyn = False
    ll_len = ll_len_fix
    d_len = d_len_fix
    hdr_bits = 3
    body_dyn = body_fix
    if not fixed_only:
        ll_len_dyn = code_lengths(freq_ll, C.MAX_CODE_BITS)
        d_len_dyn = code_lengths(freq_d, C.MAX_CODE_BITS)
        body_dyn = int(
            (freq_ll * ll_len_dyn).sum() + (freq_d * d_len_dyn).sum()
        )
        hlit = max(257, int(np.max(np.nonzero(ll_len_dyn[:286])[0])) + 1)
        hdist = max(1, int(np.max(np.nonzero(d_len_dyn[:30])[0])) + 1)
        combined = np.concatenate([ll_len_dyn[:hlit], d_len_dyn[:hdist]])
        rle = cl_rle(combined)
        freq_cl = np.zeros(19, np.int64)
        for s, _, _ in rle:
            freq_cl[s] += 1
        cl_len = code_lengths(freq_cl, C.MAX_CL_CODE_BITS)
        cl_code = canonical_codes_lsb(cl_len)
        perm = cl_len[C.CL_ORDER]
        nz = np.nonzero(perm)[0]
        hclen = max(4, (int(nz[-1]) + 1) if nz.size else 4)

        hdr_dyn_bits = (
            3 + 14 + 3 * hclen
            + sum(int(cl_len[s]) + eb for s, _, eb in rle)
        )
        if hdr_dyn_bits + body_dyn < 3 + body_fix:
            use_dyn = True
            ll_len, d_len = ll_len_dyn, d_len_dyn
            hdr_bits = hdr_dyn_bits
            f = [(bfinal, 1), (2, 2),
                 (hlit - 257, 5), (hdist - 1, 5), (hclen - 4, 4)]
            for i in range(hclen):
                f.append((int(perm[i]), 3))
            for s, ev, eb in rle:
                f.append((int(cl_code[s]), int(cl_len[s])))
                if eb:
                    f.append((ev, eb))
            if len(f) > HDR_SLOTS:
                raise ValueError(f"dynamic header needs {len(f)} fields")
            for i, (v, b) in enumerate(f):
                hdr_vals[i] = v
                hdr_nbits[i] = b
    if not use_dyn:
        hdr_vals[0] = bfinal
        hdr_nbits[0] = 1
        hdr_vals[1] = 1  # BTYPE=01 fixed
        hdr_nbits[1] = 2
        hdr_bits = 3

    ll_code = canonical_codes_lsb(ll_len)
    d_code = canonical_codes_lsb(d_len)
    return {
        "ll_len": ll_len.astype(np.int32),
        "ll_code": ll_code,
        "d_len": d_len.astype(np.int32),
        "d_code": d_code,
        "hdr_vals": hdr_vals,
        "hdr_nbits": hdr_nbits,
        "use_dynamic": use_dyn,
        "hdr_bits": hdr_bits,
        "body_bits": body_dyn if use_dyn else body_fix,
    }
