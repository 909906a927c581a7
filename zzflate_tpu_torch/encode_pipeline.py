"""Batched two-phase encode pipeline (the mechanism).

Port of ``zzflate_tpu/encode_pipeline.py``: batch staging, the
analyze -> plan -> emit -> finish queue and the device<->host transfers.
The stitching policy lives in encode_policy.py.

Pipeline shape: device analyze (match, parse, histograms) for every
batch, host Huffman/header build (at levels 7-9 then the optimal parse
over the device's matches, on the card for a CUDA device and in C on the
host for the CPU, and a second build from its tokens), device emit, host
stitch in order.
Eager CUDA is asynchronous, so the overlap comes from the queue order:
batch i+1's analyze is queued on the device before the host plans batch
i, and one worker thread fetches and stitches finished batches in order
while the main thread plans and queues the next ones. Device-to-host
copies run on a side stream behind an event of the work they wait for,
so a fetch never waits for the batches queued after it. Device memory
stays a constant number of batches whatever the input size. Over a
device list (a mesh) each batch splits into equal row groups, one per
device, each with its own upload, analyze, emit and copy stream; the
host plans all rows at once.
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
    stream_final: bool  # the last chunk closes the stream
    frame: bool  # sync-flush framed segments, else (bytes, nbits)
    with_anchors: bool
    halo: bool
    devices: list  # the mesh: row group j of every batch runs on devices[j]
    with_checksums: bool  # per-chunk Adler-32/CRC-32 partials, on the card
    # derived
    chunk_bytes: int = 0
    out_words: int = 0
    params: object = None
    huffman_only: bool = False
    fixed_only: bool = False
    optimal: bool = False  # levels 7-9: the DP replaces the lazy parse
    n: int = 0
    nchunks: int = 0
    bsz: int = 0  # rows of one batch over the whole mesh
    per_dev: int = 0  # rows of one batch on each device
    max_dist: int = 32768
    copy_streams: dict = field(default_factory=dict)  # device -> side stream
    results: dict = field(default_factory=dict)


def _fetch(ctx: _Ctx, t: torch.Tensor, after=None):
    """Start copying `t` to the host once its device's current stream has
    done its queued work (or the event `after`); returns a callable that
    waits for the copy and gives the numpy array."""
    if t.device.type != "cuda":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    s = ctx.copy_streams[t.device]
    if after is None:
        s.wait_stream(torch.cuda.current_stream(t.device))
    else:
        s.wait_event(after)
    with torch.cuda.device(t.device), torch.cuda.stream(s):
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


def _make_ctx(data, config, dictionary, stream_final, frame, with_anchors,
              halo, devices, with_checksums) -> _Ctx:
    ctx = _Ctx(data=data, config=config, dictionary=dictionary,
               stream_final=stream_final, frame=frame,
               with_anchors=with_anchors, halo=halo, devices=devices,
               with_checksums=with_checksums)
    ctx.chunk_bytes = config.chunk_bytes
    ctx.out_words = deflate_encoder.output_words_bound(ctx.chunk_bytes)
    ctx.params = config.params
    ctx.huffman_only = config.strategy == cfg_mod.STRATEGY_HUFFMAN_ONLY
    ctx.fixed_only = config.strategy == cfg_mod.STRATEGY_FIXED
    ctx.optimal = ctx.params.optimal and not ctx.huffman_only
    ctx.n = len(data)
    ctx.nchunks = max(1, -(-ctx.n // ctx.chunk_bytes))
    # One batch is ndev x per_dev rows. Never batch far beyond the real
    # chunk count (padded rows run the full analyze/emit for nothing):
    # the per-device row count is capped at the pow2 above its share.
    ndev = len(devices)
    share = -(-ctx.nchunks // ndev)
    cap = 1 << max(0, share - 1).bit_length()
    ctx.per_dev = max(1, min(_device_batch(ctx.chunk_bytes, config.mem_level),
                             cap))
    ctx.bsz = ndev * ctx.per_dev
    ctx.max_dist = min(32768, 1 << config.window_bits)
    for dev in devices:
        if dev.type == "cuda" and dev not in ctx.copy_streams:
            ctx.copy_streams[dev] = torch.cuda.Stream(dev)
    return ctx


def _parts(ctx: _Ctx):
    """(device, first row, end row) of each device's rows of a batch."""
    pd = ctx.per_dev
    return [(dev, j * pd, (j + 1) * pd) for j, dev in enumerate(ctx.devices)]


def _dispatch_analyze(ctx: _Ctx, b0: int):
    """Stage host rows for chunks [b0, b0+bsz) and queue analysis, each
    device on its own rows.

    Returns the slice and, per device, its row range, analysis, the wait
    for its freqs, the wait for its checksum partials (or None) and, at
    levels 7-9, the rows the DP reads: (data, starts, valid_ends) as the
    analysis took them."""
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
        host = [torch.as_tensor(a) for a in (buf, starts, valid_ends,
                                              window_starts)]
        uploads = []
        for dev, r0, r1 in _parts(ctx):
            rows = [t[r0:r1] for t in host]
            if dev.type == "cuda":
                # Pinned staging: the upload does not wait for queued work.
                rows = [t.pin_memory() for t in rows]
                with torch.cuda.device(dev):
                    rows = [t.to(dev, non_blocking=True) for t in rows]
            uploads.append(rows)
    parts = []
    with maybe_stage("analyze_dispatch", ctx.devices):
        for (dev, r0, r1), db in zip(_parts(ctx), uploads):
            ana = deflate_encoder.analyze_chunks_batch(
                *db, ctx.params, huffman_only=ctx.huffman_only,
                strategy=ctx.config.strategy, max_dist=ctx.max_dist,
                with_checksums=ctx.with_checksums,
            )
            dp_in = tuple(db[:3]) if ctx.optimal else None
            cks = _fetch(ctx, ana["cks"]) if ctx.with_checksums else None
            parts.append((dev, r0, r1, ana, _fetch(ctx, ana["freqs"]), cks,
                          dp_in))
    return (b0, b1), parts


def _plan_and_emit(ctx: _Ctx, sl, parts):
    """Take the small freqs of every device, build tables on the host (at
    levels 7-9 re-parse with the optimal DP and rebuild them), queue each
    device's emit of its own rows. The per-position analysis arrays are
    dropped afterwards."""
    b0, b1 = sl
    with maybe_stage("analyze_fetch_freqs"):
        # (bsz, SB, 288 + 30), rows in device order.
        freqs = np.concatenate([p[4]() for p in parts])
        freq_ll = freqs[..., :288]
        freq_d = freqs[..., 288:]
    with maybe_stage("host_plan"):
        plans = [
            huffman_host.build_chunk_plan(
                freq_ll[j], freq_d[j],
                bfinal=int(policy.is_final(ctx, b0 + j)),
                fixed_only=ctx.fixed_only,
            )
            for j in range(ctx.bsz)
        ]
    ntok_rows = freq_ll.sum(axis=(1, 2))
    kbm = policy.keep_bits_budget(ctx, b0, b1)
    # Token-compacted emit when every committed token count of a device's
    # rows (the lazy parse's, or the DP's own) fits the static budget;
    # barely-compressible rows take full width. Each device compacts its
    # own rows only, so no word crosses devices.
    budget = deflate_encoder.token_budget(ctx.chunk_bytes)
    emits = []
    for dev, r0, r1, ana, _, cks, dp_in in parts:
        ntok = int(ntok_rows[r0:r1].max())
        if dp_in is not None:
            with maybe_stage("optimal_parse", dev):
                sub = plans[r0:r1]
                override, ntok = policy.optimal_parse(
                    ctx, sub, ana, dp_in, b0 + r0,
                )
                plans[r0:r1] = sub
                ana = dict(ana, **override)
        with maybe_stage("plan_upload"):
            tables = interop.plan_stack(plans[r0:r1], dev)
        tok_slots = budget if ntok <= budget else 0
        with maybe_stage("emit_dispatch", dev):
            res = deflate_encoder.emit_chunks_batch(
                ana, ctx.out_words,
                tables["ll_len"], tables["ll_code"], tables["d_len"],
                tables["d_code"], tables["hdr_vals"], tables["hdr_nbits"],
                tables["eob_v"], tables["eob_nb"],
                keep_bits_max=torch.as_tensor(kbm[r0:r1]).to(dev),
                with_anchors=ctx.with_anchors,
                token_slots=tok_slots,
            )
        emitted = None
        if dev.type == "cuda":
            # On this device's stream, not the calling thread's device.
            emitted = torch.cuda.Event()
            emitted.record(torch.cuda.current_stream(dev))
        emits.append((res, kbm[r0:r1], emitted, cks))
    return sl, plans, emits


def _fetch_words(ctx: _Ctx, res, kbm, emitted):
    """One device's finished rows: its packed metadata first (one copy:
    bit counts, sub-block offsets, anchors), then exactly the used words
    of its rows. Returns (meta, per-row word arrays)."""
    meta = _fetch(ctx, res["meta"], emitted)()
    nbits_np = meta[:, 0]
    # Per-chunk word counts by the rule the device used.
    cnt_np = ((nbits_np.astype(np.int64) + 3 + 31) // 32)
    cnt_np = np.where(nbits_np <= kbm, cnt_np, 0)
    w_off = np.concatenate([[0], np.cumsum(cnt_np)])
    flat_np = _fetch(
        ctx, res["flat_words"][: int(w_off[-1])], emitted
    )().view("<u4")
    return meta, [flat_np[w_off[j] : w_off[j + 1]] for j in range(len(meta))]


def _finish(ctx: _Ctx, sl, plans, emits):
    """Fetch the finished batch, device by device, and assemble its
    segments (and checksum partials) in chunk order."""
    out = ctx.results
    b0, b1 = sl
    with maybe_stage("emit_fetch"):
        metas, words = [], []
        for res, kbm, emitted, _ in emits:
            meta, w = _fetch_words(ctx, res, kbm, emitted)
            metas.append(meta)
            words += w
        meta = np.concatenate(metas)
        sbw = emits[0][0]["sb_bits"].shape[1]
        aw = emits[0][0]["anc_bit"].shape[1]
        nbits_np = meta[:, 0]
        sb_bits_np = meta[:, 1 : 1 + sbw]
        sb_out_np = meta[:, 1 + sbw : 1 + 2 * sbw]
        anc_bit_np = meta[:, 1 + 2 * sbw : 1 + 2 * sbw + aw]
        anc_out_np = meta[:, 1 + 2 * sbw + aw :]
        keep = [
            policy.host_keep(ctx, b0 + j, int(nbits_np[j]))
            for j in range(b1 - b0)
        ]
        if ctx.with_checksums:
            # (bsz, 2) int64: one copy per device; padded rows dropped.
            cks = np.concatenate([e[3]() for e in emits])[: b1 - b0]
            out["adler"].extend(int(x) for x in cks[:, 0])
            out["crc"].extend(int(x) for x in cks[:, 1])
    with maybe_stage("stitch"):
        for j in range(b1 - b0):
            i = b0 + j
            nbits = int(nbits_np[j])
            out["segments"].append(
                policy.assemble_chunk(ctx, i, nbits, words[j], keep[j])
            )
            if not ctx.frame or not keep[j]:
                # Unframed segments carry no index; a stored fallback's
                # block entries are meaningless (the decoder detects
                # BTYPE=0).
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
                    devices: list, stream_final: bool = True,
                    frame: bool = True, with_anchors: bool = False,
                    halo: bool = True, with_checksums: bool = False) -> dict:
    """Deflate payload as byte-aligned per-chunk segments, each
    sync-flush framed except the final one. Returns {"segments",
    "blocks", "anchors", "adler", "crc"}, one entry per chunk ("adler"
    and "crc" are None unless with_checksums).

    stream_final=False leaves the stream open: the last chunk is framed
    like the others (BFINAL 0, sync-flush marker, the non-final stored
    rule). frame=False returns unframed (bytes, nbits) segments with no
    sync marker, no stored fallback and no index rows, the last byte
    possibly partial, for callers that join them at bit granularity (the
    stream layer's Z_BLOCK).

    devices is the mesh, a list of torch.device, each CUDA one with its
    index (api._resolve_device, parallel.make_mesh); it may name one
    device more than once, and one device stands for [device]. Every
    batch has len(devices) x per_dev rows, and rows [j*per_dev,
    (j+1)*per_dev) run on devices[j]: upload, analyze, emit and copies.
    The bytes do not depend on the layout at chunk_bytes >= 32 KiB.
    Below that a chunk's halo reaches back past the previous chunk and is
    cut at a batch's first row (as in the reference), so moving the batch
    boundaries moves matches; the stream still decodes. with_checksums
    computes each chunk's Adler-32 and CRC-32 on its device during
    analyze and returns them in chunk order, for container trailers that
    never read the input again."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = [torch.device(d) for d in devices]
    ctx = _make_ctx(data, config, dictionary, stream_final, frame,
                    with_anchors, halo, devices, with_checksums)
    ctx.results = {
        "segments": [], "blocks": [], "anchors": [],
        "adler": [] if with_checksums else None,
        "crc": [] if with_checksums else None,
    }

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
