"""Stitching policy for the batched encode pipeline.

Port of ``zzflate_tpu/encode_policy.py:23-99`` for the whole-buffer
``compress`` path (every segment framed, the last chunk final): when the
stored fallback beats the Huffman segment, the device-side keep_bits_max
budget that mirrors it, how a finished chunk becomes a framed segment,
and its block/anchor index rows. The level 7-9 optimal-parse override
comes with the optimal-parse slice.
"""
from __future__ import annotations

import numpy as np

from zzflate_tpu_torch.utils import containers


def _stored_len(ctx, i: int) -> int:
    clen = min(ctx.chunk_bytes, max(0, ctx.n - i * ctx.chunk_bytes))
    return 5 * max(1, -(-clen // 65535)) + clen


def host_keep(ctx, i: int, nbits: int) -> bool:
    """True when chunk i's Huffman segment beats its stored fallback."""
    stored_len = _stored_len(ctx, i)
    if i == ctx.nchunks - 1:
        return (nbits + 7) // 8 <= stored_len
    return (nbits + 10) // 8 + 4 <= stored_len


def keep_bits_budget(ctx, b0: int, b1: int) -> np.ndarray:
    """Per-chunk bit budget above which the stitcher picks the stored
    fallback, so the device skips those words. Non-final segments cost
    ceil((nbits+3)/8)+4 bytes (sync-flush opener + marker), final ones
    ceil(nbits/8); stored costs 5*ceil(L/65535)+L."""
    kbm = np.full((ctx.bsz,), np.iinfo(np.int32).max, np.int32)
    for j in range(b1 - b0):
        i = b0 + j
        stored_len = _stored_len(ctx, i)
        if i == ctx.nchunks - 1:
            kbm[j] = 8 * stored_len
        else:
            kbm[j] = 8 * (stored_len - 4) - 3
    return kbm


def assemble_chunk(ctx, i: int, nbits: int, words_np, keep: bool) -> bytes:
    """One chunk's framed segment bytes."""
    final = i == ctx.nchunks - 1
    if not keep:
        chunk = ctx.data[i * ctx.chunk_bytes : (i + 1) * ctx.chunk_bytes]
        return containers.stored_segment(chunk, final=final)
    if final:
        return words_np.tobytes()[: (nbits + 7) // 8]
    # +3 zero bits open the sync-flush empty stored block; its alignment
    # padding is zeros too (the buffer starts zeroed).
    return (
        words_np.tobytes()[: (nbits + 3 + 7) // 8]
        + containers.SYNC_FLUSH_MARKER
    )


def index_rows(plan, sb_bits_row, sb_out_row, anc_bit_row, anc_out_row):
    """Block/anchor index entries for one kept chunk.

    Blocks: (bit offset in segment, output offset in chunk) per
    block-group start. Anchors: interior sub-blocks of merged groups plus
    the emit phase's every-ANCHOR_TOKENS slots."""
    blocks = [
        (int(sb_bits_row[g[0]]), int(sb_out_row[g[0]]))
        for g in plan["groups"]
    ]
    anc = [
        (int(sb_bits_row[b]), int(sb_out_row[b]))
        for g in plan["groups"]
        for b in g[1:]
    ]
    valid = anc_bit_row >= 0
    anc += [
        (int(bb), int(oo))
        for bb, oo in zip(anc_bit_row[valid], anc_out_row[valid])
    ]
    anc.sort()
    return blocks, anc
