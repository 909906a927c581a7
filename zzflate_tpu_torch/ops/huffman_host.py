"""Host-side Huffman plan: the block groups, tables and dynamic headers
of a batch of chunks.

The per-block tree build is O(288 log 288) scalar work; it runs on the
host between the device analyze and emit phases
(models/deflate_encoder.py). ``build_batch_plans`` groups each chunk's
sub-blocks here (``plan_block_groups``, numpy) and builds every group's
tables in two batched calls of the C runtime (``native.plan_lengths``,
``native.plan_header``), which follow the reference's
``zzflate_tpu/ops/huffman_host.build_tables`` step by step and give its
arrays bit for bit.
"""
from __future__ import annotations

import numpy as np

from zzflate_tpu_torch import native
from zzflate_tpu_torch.utils.profiling import maybe_stage

HDR_SLOTS = 672


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


def build_batch_plans(
    freq_ll: np.ndarray,
    freq_d: np.ndarray,
    bfinal,
    fixed_only: bool = False,
) -> list[dict]:
    """Per-sub-block table/header arrays of every chunk of a batch, the
    tables of all its block groups built in two C calls. freq_ll (B, SB,
    288), freq_d (B, SB, 30), bfinal (B,).

    Adjacent sub-blocks with similar statistics share one deflate block
    (``plan_block_groups``): the group's header rides its first sub-block
    (hdr widths 0 on the rest), its EOB the last. Returns one dict a
    chunk of (SB, ...) arrays, views of (B, SB, ...) arrays: ll_len/ll_code
    (SB, 288), d_len/d_code (SB, 30), hdr_vals/hdr_nbits (SB, HDR_SLOTS),
    eob_v/eob_nb (SB,), and "groups". Raises ValueError when a dynamic
    header needs more than HDR_SLOTS fields."""
    bsz, sb = freq_ll.shape[:2]
    with maybe_stage("host_plan_blocks"):
        groups = [plan_block_groups(freq_ll[j], freq_d[j])
                  for j in range(bsz)]
    # Groups tile the batch's rows (chunk-major sub-blocks) in order; the
    # chunk's BFINAL rides its last group.
    bounds = np.cumsum([0] + [len(m) for gs in groups for m in gs])
    gbf = np.zeros(len(bounds) - 1, np.int64)
    gbf[np.cumsum([len(gs) for gs in groups]) - 1] = bfinal

    def group_sums(freq):
        return np.add.reduceat(freq.reshape(bsz * sb, -1).astype(np.int64),
                               bounds[:-1])

    lengths = None
    if not fixed_only:
        with maybe_stage("host_plan_lengths"):
            lengths = native.plan_lengths(group_sums(freq_ll),
                                          group_sums(freq_d))
    with maybe_stage("host_plan_header"):
        t = native.plan_header(lengths, gbf, bounds, HDR_SLOTS)
    t = {k: v.reshape(bsz, sb, *v.shape[1:]) for k, v in t.items()}
    return [dict({k: v[j] for k, v in t.items()}, groups=groups[j])
            for j in range(bsz)]
