"""Stitching and parse policy for the batched encode pipeline.

Port of ``zzflate_tpu/encode_policy.py``: when the stored fallback
beats the Huffman segment, the device-side keep_bits_max budget that
mirrors it, how a finished chunk becomes a framed segment (or, unframed,
a (bytes, nbits) pair), its block/anchor index rows, and the level 7-9
optimal-parse override (the DP on the card for a CUDA device, the C DP on
the host for the CPU). The last chunk is final only when the run is
``stream_final`` (the stream layer's and the resumable shards' runs are
not).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from zzflate_tpu_torch import constants as C
from zzflate_tpu_torch import native
from zzflate_tpu_torch.models import deflate_encoder
from zzflate_tpu_torch.ops import huffman_host, kernels, matcher
from zzflate_tpu_torch.utils import containers
from zzflate_tpu_torch.utils.profiling import maybe_stage

_WINDOW = 32768


def _stored_len(ctx, i: int) -> int:
    clen = min(ctx.chunk_bytes, max(0, ctx.n - i * ctx.chunk_bytes))
    return 5 * max(1, -(-clen // 65535)) + clen


def is_final(ctx, i: int) -> bool:
    """Chunk i closes the stream (BFINAL set, no sync-flush framing)."""
    return i == ctx.nchunks - 1 and ctx.stream_final


def host_keep(ctx, i: int, nbits: int) -> bool:
    """True when chunk i's Huffman segment beats its stored fallback
    (always, unframed: it has none)."""
    if not ctx.frame:
        return True
    stored_len = _stored_len(ctx, i)
    if is_final(ctx, i):
        return (nbits + 7) // 8 <= stored_len
    return (nbits + 10) // 8 + 4 <= stored_len


def keep_bits_budget(ctx, b0: int, b1: int) -> np.ndarray:
    """Per-chunk bit budget above which the stitcher picks the stored
    fallback, so the device skips those words. Non-final segments cost
    ceil((nbits+3)/8)+4 bytes (sync-flush opener + marker), final ones
    ceil(nbits/8); stored costs 5*ceil(L/65535)+L. Unframed runs keep
    every chunk's words (INT32_MAX on every row)."""
    kbm = np.full((ctx.bsz,), np.iinfo(np.int32).max, np.int32)
    if not ctx.frame:
        return kbm
    for j in range(b1 - b0):
        i = b0 + j
        stored_len = _stored_len(ctx, i)
        if is_final(ctx, i):
            kbm[j] = 8 * stored_len
        else:
            kbm[j] = 8 * (stored_len - 4) - 3
    return kbm


def assemble_chunk(ctx, i: int, nbits: int, words_np, keep: bool):
    """One chunk's framed segment bytes, or unframed (bytes, nbits): no
    sync marker, the last byte possibly partial."""
    final = is_final(ctx, i)
    if not ctx.frame:
        return (words_np.tobytes()[: (nbits + 7) // 8], nbits)
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


def optimal_override(ctx, plans, ana, mm_packed, buf, valid_ends, b0: int):
    """Levels 7-9 off the card: replace the lazy parse of one batch with
    the C shortest-bit-path DP over the device matcher's (mlen, mdist), priced
    by the pass-1 trees in `plans`, then rebuild each chunk's plan from
    the DP's own tokens.

    mm_packed, buf, valid_ends: the batch's host (B, N) int32 candidates
    (mlen << 16 | mdist), (B, N) uint8 rows and (B,) ends. Every row is
    parsed, padded ones too (they are empty). Replaces `plans` in place;
    returns the emit's override arrays (committed, is_match, litlen_sym,
    lcode, mlen = the DP's length; the analysis' own dcode and mdist) on
    the analysis' device and the largest committed-token count of a row.
    Port of ``zzflate_tpu/encode_policy.py:102-186``."""
    bsz, nn = buf.shape
    mlen = mm_packed >> 16
    mdist = mm_packed & 0xFFFF
    bounds = deflate_encoder.sub_block_bounds(nn)
    sbn = len(bounds) - 1
    fll = np.zeros((bsz, sbn, C.NUM_LITLEN_SYMBOLS), np.int64)
    fd = np.zeros((bsz, sbn, C.NUM_DIST_SYMBOLS), np.int64)
    com_b = np.zeros((bsz, nn), bool)
    take_b = np.zeros((bsz, nn), bool)
    sel_b = np.zeros((bsz, nn), np.int32)
    sym_b = np.zeros((bsz, nn), np.int32)
    lcode_b = np.zeros((bsz, nn), np.int32)
    for j in range(bsz):
        with maybe_stage("optimal_parse_dp"):  # the C DP's own share
            com, take, sel = native.optimal_parse(
                buf[j], mlen[j], mdist[j], _WINDOW, int(valid_ends[j]),
                plans[j]["ll_len"], plans[j]["d_len"], bounds,
            )
        com_b[j], take_b[j], sel_b[j] = com, take, sel
        lc = C.LENGTH_TO_CODE[np.clip(sel, 0, C.MAX_MATCH)]
        lcode_b[j] = lc
        sym_b[j] = np.where(take, 257 + lc, buf[j].astype(np.int32))
        # Distance codes of the taken matches only.
        tk = np.flatnonzero(take)
        dcode = np.searchsorted(C.DIST_BASE, mdist[j, tk], side="right") - 1
        for b in range(sbn):
            s, e = bounds[b], bounds[b + 1]
            fll[j, b] = np.bincount(sym_b[j, s:e][com[s:e]],
                                    minlength=C.NUM_LITLEN_SYMBOLS)
            fd[j, b] = np.bincount(dcode[(tk >= s) & (tk < e)],
                                   minlength=C.NUM_DIST_SYMBOLS)
    # Each row's DP above read its own pass-1 plan; all are rebuilt now.
    plans[:] = huffman_host.build_batch_plans(
        fll, fd, [int(is_final(ctx, b0 + j)) for j in range(bsz)],
        fixed_only=ctx.fixed_only,
    )

    dev = ana["dcode"].device

    def up(a):
        return torch.as_tensor(a).to(dev)

    override = {
        "committed": up(com_b),
        "is_match": up(take_b),
        "litlen_sym": up(sym_b),
        "lcode": up(lcode_b),
        "mlen": up(sel_b),
        "dcode": ana["dcode"],
        "mdist": ana["mdist"],
    }
    return override, int(com_b.sum(axis=1).max())


def optimal_parse(ctx, plans, ana, rows, b0: int):
    """Levels 7-9: the optimal parse's override of one batch, where its
    analysis ran: optimal_override_card on a CUDA device, else the C DP
    (optimal_override) over the analysis' packed candidates. rows: the
    batch's (data, starts, valid_ends) as the analysis took them. Replaces
    `plans` in place; returns the override arrays and the largest token
    count of a row."""
    data, _, valid_ends = rows
    if data.device.type == "cuda":
        return optimal_override_card(ctx, plans, ana, rows, b0)
    return optimal_override(ctx, plans, ana, ana["mm_packed"].numpy(),
                            data.numpy(), valid_ends.numpy(), b0)


@functools.lru_cache(maxsize=None)
def _bounds_on(n: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(deflate_encoder.sub_block_bounds(n),
                        dtype=torch.int32, device=device)


def optimal_override_card(ctx, plans, ana, rows, b0: int):
    """optimal_override on a CUDA device: the same override arrays, plans
    and largest token count, with the DP and its tokens on the card. The
    optimal_dp kernel chooses each position's length from the analysis'
    (mlen, mdist) priced by the pass-1 trees in `plans`, parse_rows commits
    the choices from each chunk's start (as for the lazy parse), and the
    sub-block histograms of the DP's tokens come back in one copy for the
    re-plan. rows: the batch's device (data, starts, valid_ends) as the
    analysis took them. Only the pass-1 code lengths go up, (B, SB, 318)
    int32; no (B, N) array crosses between host and card."""
    data, starts, valid_ends = rows
    dev = data.device
    with maybe_stage("optimal_parse_dp", dev):
        lens = torch.from_numpy(np.stack([
            np.concatenate([p["ll_len"], p["d_len"]], axis=1) for p in plans
        ]).astype(np.int32))
        if dev.type == "cuda":
            # Pinned staging: the upload does not wait for queued work.
            lens = lens.pin_memory()
        lens = lens.to(dev, non_blocking=True)
        choice = kernels.optimal_dp(
            data, ana["mlen"], ana["mdist"], starts, valid_ends, lens,
            _bounds_on(data.shape[1], dev),
        )
        committed = matcher.commit_steps(torch.where(choice >= 3, choice, 1),
                                         starts, valid_ends)
        take = committed & (choice >= 3)
        mlen = torch.where(take, choice, 0)
        lcode = deflate_encoder._len_code(mlen)  # LENGTH_TO_CODE, 0 at 0
        sym = torch.where(take, 257 + lcode, data.int())
        freqs = deflate_encoder.sub_block_freqs(sym, committed, ana["dcode"],
                                                take)["freqs"]
        freqs = freqs.cpu().numpy().astype(np.int64)
    ntok = int(freqs[:, :, :C.NUM_LITLEN_SYMBOLS].sum(axis=(1, 2)).max())
    plans[:] = huffman_host.build_batch_plans(
        freqs[:, :, :C.NUM_LITLEN_SYMBOLS], freqs[:, :, C.NUM_LITLEN_SYMBOLS:],
        [int(is_final(ctx, b0 + j)) for j in range(len(plans))],
        fixed_only=ctx.fixed_only,
    )
    override = {
        "committed": committed,
        "is_match": take,
        "litlen_sym": sym,
        "lcode": lcode,
        "mlen": mlen,
        "dcode": ana["dcode"],
        "mdist": ana["mdist"],
    }
    return override, ntok
