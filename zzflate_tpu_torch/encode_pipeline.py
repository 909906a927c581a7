"""Batched two-phase encode pipeline (the mechanism).

Port of ``zzflate_tpu/encode_pipeline.py``: batch staging, the
analyze -> plan -> emit -> finish queue and the device<->host transfers.
The stitching policy lives in encode_policy.py.

Pipeline shape: device analyze (match, parse, histograms) for every
batch, host Huffman/header build, device emit, host stitch in order.
Eager CUDA is asynchronous, so the overlap comes from the queue order:
batch i+1's analyze is queued on the device before the host plans batch
i, and one worker thread fetches and stitches finished batches in order
while the main thread plans and queues the next ones. Device-to-host
copies run on a side stream behind an event of the work they wait for,
so a fetch never waits for the batches queued after it. Device memory
stays a constant number of batches whatever the input size.
"""
from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from zzflate_tpu_torch import config as cfg_mod
from zzflate_tpu_torch import encode_policy as policy
from zzflate_tpu_torch import interop
from zzflate_tpu_torch.models import deflate_encoder
from zzflate_tpu_torch.ops import huffman_host
from zzflate_tpu_torch.utils.profiling import maybe_stage

_WINDOW = 32768
_BATCH_BYTES = 4 << 20  # chunk data per device batch at mem_level 8


@dataclass
class _Ctx:
    """Everything one encode run's stages share (read-only after init)."""

    data: bytes
    config: object
    dictionary: bytes | None
    with_anchors: bool
    halo: bool
    device: torch.device
    # derived
    chunk_bytes: int = 0
    out_words: int = 0
    params: object = None
    huffman_only: bool = False
    fixed_only: bool = False
    n: int = 0
    nchunks: int = 0
    bsz: int = 0
    max_dist: int = 32768
    copy_stream: object = None  # side stream of the device-to-host copies
    results: dict = field(default_factory=dict)


def _fetch(ctx: _Ctx, t: torch.Tensor, after=None):
    """Start copying `t` to the host once the current stream's queued
    work (or the event `after`) is done; returns a callable that waits
    for the copy and gives the numpy array."""
    if t.device.type != "cuda":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    s = ctx.copy_stream
    if after is None:
        s.wait_stream(torch.cuda.current_stream(t.device))
    else:
        s.wait_event(after)
    with torch.cuda.stream(s):
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(s)

    def wait():
        done.synchronize()
        return host.numpy()

    return wait


def _device_batch(chunk_bytes: int, mem_level: int = 8) -> int:
    """Chunks per device batch: ~4 MiB of chunk data at mem_level 8 (the
    suffix-sort matcher holds ~20 arrays per position); each mem_level
    step below 8 halves it, 9 doubles it."""
    shift = mem_level - 8
    budget = _BATCH_BYTES << shift if shift >= 0 else _BATCH_BYTES >> -shift
    return max(1, min(64, budget // chunk_bytes))


def build_chunk_batch(data: bytes, chunk_bytes: int,
                      dictionary: bytes | None, halo: bool = True):
    """Lay out (nchunks, 32K + chunk_bytes) rows with halo prefixes.

    Chunk i's prefix is chunk i-1's last 32 KiB; chunk 0's is the preset
    dictionary. halo=False leaves every prefix empty (window reset per
    chunk, the seekable layout). Returns (buf, valid_ends, window_starts,
    nchunks)."""
    n = len(data)
    nchunks = max(1, -(-n // chunk_bytes))
    buf = np.zeros((nchunks, _WINDOW + chunk_bytes), dtype=np.uint8)
    valid_ends = np.zeros((nchunks,), dtype=np.int32)
    window_starts = np.zeros((nchunks,), dtype=np.int32)
    for i in range(nchunks):
        chunk = data[i * chunk_bytes : (i + 1) * chunk_bytes]
        if not halo:
            prefix = b""
        elif i == 0:
            prefix = (dictionary or b"")[-_WINDOW:]
        else:
            prefix = data[max(0, i * chunk_bytes - _WINDOW) : i * chunk_bytes]
        if prefix:
            buf[i, _WINDOW - len(prefix) : _WINDOW] = np.frombuffer(
                prefix, np.uint8
            )
        if chunk:
            buf[i, _WINDOW : _WINDOW + len(chunk)] = np.frombuffer(
                chunk, np.uint8
            )
        valid_ends[i] = _WINDOW + len(chunk)
        window_starts[i] = _WINDOW - len(prefix)
    return buf, valid_ends, window_starts, nchunks


def _make_ctx(data, config, dictionary, with_anchors, halo, device) -> _Ctx:
    ctx = _Ctx(data=data, config=config, dictionary=dictionary,
               with_anchors=with_anchors, halo=halo, device=device)
    ctx.chunk_bytes = config.chunk_bytes
    ctx.out_words = deflate_encoder.output_words_bound(ctx.chunk_bytes)
    ctx.params = config.params
    ctx.huffman_only = config.strategy == cfg_mod.STRATEGY_HUFFMAN_ONLY
    ctx.fixed_only = config.strategy == cfg_mod.STRATEGY_FIXED
    ctx.n = len(data)
    ctx.nchunks = max(1, -(-ctx.n // ctx.chunk_bytes))
    # Never batch far beyond the real chunk count (padded rows run the
    # full analyze/emit for nothing); pow2 bucketing bounds the waste.
    cap = 1 << max(0, ctx.nchunks - 1).bit_length()
    ctx.bsz = max(1, min(_device_batch(ctx.chunk_bytes, config.mem_level), cap))
    ctx.max_dist = min(32768, 1 << config.window_bits)
    if device.type == "cuda":
        ctx.copy_stream = torch.cuda.Stream(device)
    return ctx


def _dispatch_analyze(ctx: _Ctx, b0: int):
    """Stage host rows for chunks [b0, b0+bsz) and queue analysis."""
    b1 = min(b0 + ctx.bsz, ctx.nchunks)
    cb = ctx.chunk_bytes
    with maybe_stage("build_batches"):
        buf, valid_ends, window_starts, _ = build_chunk_batch(
            ctx.data[b0 * cb : b1 * cb], cb,
            ctx.dictionary if b0 == 0
            else ctx.data[max(0, b0 * cb - _WINDOW) : b0 * cb],
            halo=ctx.halo,
        )
        pad = ctx.bsz - (b1 - b0)
        if pad:
            # Padded tail rows encode an empty block the stitcher ignores.
            buf = np.concatenate(
                [buf, np.zeros((pad,) + buf.shape[1:], buf.dtype)]
            )
            valid_ends = np.concatenate(
                [valid_ends, np.full((pad,), _WINDOW, np.int32)]
            )
            window_starts = np.concatenate(
                [window_starts, np.full((pad,), _WINDOW, np.int32)]
            )
        starts = np.full((ctx.bsz,), _WINDOW, dtype=np.int32)
        dev = ctx.device
        host = [torch.as_tensor(a) for a in (buf, starts, valid_ends,
                                              window_starts)]
        if dev.type == "cuda":
            # Pinned staging: the upload does not wait for queued work.
            host = [t.pin_memory() for t in host]
        db = tuple(t.to(dev, non_blocking=True) for t in host)
    with maybe_stage("analyze_dispatch", dev):
        ana = deflate_encoder.analyze_chunks_batch(
            *db, ctx.params, huffman_only=ctx.huffman_only,
            strategy=ctx.config.strategy, max_dist=ctx.max_dist,
        )
    return (b0, b1), ana, _fetch(ctx, ana["freqs"])


def _plan_and_emit(ctx: _Ctx, sl, ana, freqs_wait):
    """Take the small freqs, build tables on the host, queue the emit.
    The per-position analysis arrays are dropped afterwards."""
    b0, b1 = sl
    with maybe_stage("analyze_fetch_freqs"):
        freqs = freqs_wait()  # (bsz, SB, 288 + 30)
        freq_ll = freqs[..., :288]
        freq_d = freqs[..., 288:]
    with maybe_stage("host_plan"):
        plans = [
            huffman_host.build_chunk_plan(
                freq_ll[j], freq_d[j],
                bfinal=int(b0 + j == ctx.nchunks - 1),
                fixed_only=ctx.fixed_only,
            )
            for j in range(ctx.bsz)
        ]
    tables = interop.plan_stack(plans, ctx.device)
    kbm = policy.keep_bits_budget(ctx, b0, b1)

    # Token-compacted emit when every chunk's committed token count fits
    # the static budget; barely-compressible batches take full width.
    budget = deflate_encoder.token_budget(ctx.chunk_bytes)
    tok_slots = budget if int(freq_ll.sum(axis=(1, 2)).max()) <= budget else 0
    with maybe_stage("emit_dispatch", ctx.device):
        res = deflate_encoder.emit_chunks_batch(
            ana, ctx.out_words,
            tables["ll_len"], tables["ll_code"], tables["d_len"],
            tables["d_code"], tables["hdr_vals"], tables["hdr_nbits"],
            tables["eob_v"], tables["eob_nb"],
            keep_bits_max=torch.as_tensor(kbm).to(ctx.device),
            with_anchors=ctx.with_anchors,
            token_slots=tok_slots,
        )
    emitted = None
    if ctx.device.type == "cuda":
        emitted = torch.cuda.Event()
        emitted.record()
    return sl, plans, res, kbm, emitted


def _finish(ctx: _Ctx, sl, plans, res, kbm, emitted):
    """Fetch the finished batch and assemble its segments in order."""
    out = ctx.results
    b0, b1 = sl
    # The packed metadata first (one copy: bit counts, sub-block offsets,
    # anchors), then exactly the used words of the whole batch.
    with maybe_stage("emit_fetch"):
        sbw = res["sb_bits"].shape[1]
        aw = res["anc_bit"].shape[1]
        meta = _fetch(ctx, res["meta"], emitted)()
        nbits_np = meta[:, 0]
        sb_bits_np = meta[:, 1 : 1 + sbw]
        sb_out_np = meta[:, 1 + sbw : 1 + 2 * sbw]
        anc_bit_np = meta[:, 1 + 2 * sbw : 1 + 2 * sbw + aw]
        anc_out_np = meta[:, 1 + 2 * sbw + aw :]
        keep = [
            policy.host_keep(ctx, b0 + j, int(nbits_np[j]))
            for j in range(b1 - b0)
        ]
        # Per-chunk word counts by the rule the device used.
        cnt_np = ((nbits_np.astype(np.int64) + 3 + 31) // 32)
        cnt_np = np.where(nbits_np <= kbm, cnt_np, 0)
        w_off = np.concatenate([[0], np.cumsum(cnt_np)])
        flat_np = _fetch(
            ctx, res["flat_words"][: int(w_off[-1])], emitted
        )().view("<u4")
    with maybe_stage("stitch"):
        for j in range(b1 - b0):
            i = b0 + j
            nbits = int(nbits_np[j])
            words = flat_np[w_off[j] : w_off[j + 1]]
            out["segments"].append(
                policy.assemble_chunk(ctx, i, nbits, words, keep[j])
            )
            if not keep[j]:
                # A stored fallback's block entries are meaningless (the
                # decoder detects BTYPE=0).
                out["blocks"].append([])
                out["anchors"].append([])
                continue
            blocks, anc = policy.index_rows(
                plans[j], sb_bits_np[j], sb_out_np[j],
                anc_bit_np[j], anc_out_np[j],
            )
            out["blocks"].append(blocks)
            out["anchors"].append(anc)


def encode_segments(data: bytes, config, dictionary: bytes | None,
                    device: torch.device, with_anchors: bool = False,
                    halo: bool = True) -> dict:
    """Deflate payload as byte-aligned per-chunk segments, each
    sync-flush framed except the final one. Returns {"segments",
    "blocks", "anchors"}, one entry per chunk."""
    ctx = _make_ctx(data, config, dictionary, with_anchors, halo, device)
    ctx.results = {"segments": [], "blocks": [], "anchors": []}

    a_q: collections.deque = collections.deque()
    e_q: collections.deque = collections.deque()
    f_q: collections.deque = collections.deque()
    with ThreadPoolExecutor(max_workers=1) as pool:
        def submit_finish():
            f_q.append(pool.submit(_finish, ctx, *e_q.popleft()))
            # At most 2 finishes in flight so emit outputs don't pile up
            # on the device; .result() re-raises worker errors.
            while len(f_q) > 2:
                f_q.popleft().result()

        for b0 in range(0, ctx.nchunks, ctx.bsz):
            a_q.append(_dispatch_analyze(ctx, b0))
            if len(a_q) >= 2:
                e_q.append(_plan_and_emit(ctx, *a_q.popleft()))
            if len(e_q) >= 2:
                submit_finish()
        while a_q:
            e_q.append(_plan_and_emit(ctx, *a_q.popleft()))
        while e_q:
            submit_finish()
        while f_q:
            f_q.popleft().result()
    return ctx.results
