#!/usr/bin/env python3
"""Drive the zzflate_tpu_torch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing is caught):

1. card: the device name, nvidia-smi's name and power limit, the nvcc
   build of the three kernels from zzflate_tpu_torch/csrc and the host
   C compiler's build of the port's C runtime (zzflate_tpu_torch/native);
2. kernels: at the main-path shape (16, 294912) each kernel is held
   against its plain torch version on the card, on seeded inputs and on
   the arrays the main path's L6, L1 and L9 calls and an L7 and an L8
   call (two batches each) hand it (their order-B scans run K=20, 24
   and 32 both ways, the runtime-K instance); equality must be exact
   (the codec is integer-only). parse_rows
   and propagate_matches also on an input off that shape;
   propagate_matches also on lengths up to 65 535, an all-match row, and
   lengths 514 and 515 at the window's edge. Device times: the kernel
   (parse_rows also per launch: exits, marks; scan_candidates and
   propagate_matches on each of their real launches, with the bound and
   the share of it), the plain version, the bound, and for
   propagate_matches a library yardstick;
3. main path: compress() on a seeded 8 MiB corpus at level 6 gzip,
   level 1 zlib and level 9 gzip (the C optimal parse on the host) with
   256 KiB chunks; each output must decode to the input with stdlib zlib
   and with the port's own decompress(), and every kernel must have
   launched in each level's run (counts reset just before its first
   timed call, read just after). The median time of MAIN_REPS calls,
   MB/s, size against zlib levels 6 and 9, stage times (a separate run)
   and a torch.profiler trace (another run: device time by kernel, the
   card's idle share) are printed;
4. streaming: the 8 MiB corpus through zlib_compat.compressobj(6,
   wbits=31) in 64 KiB pieces, then Z_FINISH, on the card: one
   encode_segments call, one (1, 294912) batch, per 256 KiB chunk. The
   output must decode with stdlib gzip and with stream.Decompressor fed
   in 64 KiB pieces, and every kernel must launch in the streamed run
   (counts reset just before the first timed call, read just after).
   The median of STREAM_REPS calls in MB/s beside phase 3's one-shot L6
   gzip, size against zlib-6, stage times, a trace with the card's idle
   share, the host Decompressor's MB/s, and gzip_compat.GzipFile
   (engine="device") writing the 8 MiB in 1 MiB writes, decoded by
   stdlib gzip. Phase 2 also holds and times the kernels' launches of
   the stream's first full chunk;
5. reference bytes: a 1 MiB prefix at levels 6 and 9 on the card equals
   the port's CPU path, and a fixed 64 KiB input with 4 KiB chunks
   hashes to REF_SHA256_L6_4K at level 6 and REF_SHA256_L9_4K at level
   9, the digests the JAX reference produces (asserted by
   tests/test_torch_api.py); stream_script on the 1 MiB prefix gives
   the CPU path's bytes on every call, and on the 64 KiB input with 4
   KiB chunks hashes to REF_SHA256_STREAM_4K (asserted against the
   reference by tests/test_torch_stream.py).

The second-to-last lines are the kernels JSON and nvidia-smi's line; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import gzip
import hashlib
import io
import json
import statistics
import subprocess
import sys
import time
import zlib

MAIN_BYTES = 8 << 20
MAIN_CHUNK = 1 << 18
MAIN_REPS = 5  # timed compress() calls per level
MAIN_RUNS = ((6, "gzip"), (1, "zlib"), (9, "gzip"))  # (level, format)
STREAM_PIECE = 1 << 16  # bytes per compress() call of the streamed runs
STREAM_REPS = 3  # timed streamed runs
# Phase 2 also takes L7's and L8's launches: their scans run K=20 and 24.
KERNEL_RUNS = MAIN_RUNS + ((7, "gzip"), (8, "gzip"))
BATCH = 16  # chunks per device batch on the main path
REF_INPUT_BYTES = 1 << 16
REF_INPUT_SEED = 7
REF_SHA256_L6_4K = "5fb898053468dc47e80f13c50044f253ad40d6dc18c3b0f6b6d19f4149f7f15e"
REF_SHA256_L9_4K = "b15bf0e7a7b67912b3b05250feb1c0a9463f2aec6fd94745db5b6e324a091233"
# stream_script at level 6 gzip, 4 KiB chunks, 4 KiB pieces, on the same
# 64 KiB input.
REF_SHA256_STREAM_4K = "3306d291b7d8320e09a78c395741ea67fff581e5dd1ded45d60c9ed0f7fb9341"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# H100 SXM 32-bit integer rate: the compare, select, min and add work of
# the bounds runs on the integer pipe, 64 lanes per SM (not the 128 fp32
# lanes, nor an FMA counted twice): 132 SMs x 64 lanes x 1.98 GHz.
INT_OPS_PER_S = 132 * 64 * 1.98e9  # 16.7e12 op/s

KERNELS = {
    # name: (source, TPU kernel replaced)
    "scan_candidates": ("zzflate_tpu_torch/csrc/scan.cu",
                        "zzflate_tpu/ops/pallas_kernels.py:37"),
    "propagate_matches": ("zzflate_tpu_torch/csrc/propagate.cu",
                          "zzflate_tpu/ops/pallas_kernels.py:174"),
    "parse_rows": ("zzflate_tpu_torch/csrc/parse.cu",
                   "zzflate_tpu/ops/pallas_kernels.py:267"),
}


def log(*parts) -> None:
    print(*parts, flush=True)


def stream_script(comp, data: bytes, piece: int) -> list[bytes]:
    """Drive a stream.Compressor (the port's or the reference's) through
    every flush mode: the first quarter of `data` in `piece`-byte pieces
    and Z_SYNC_FLUSH, the second and Z_FULL_FLUSH, 1001 bytes and a
    Z_BLOCK that must leave the stream mid-byte, a quarter more arriving
    mid-byte, set_params(level=9), the rest and Z_FINISH. Returns the
    output of every call."""
    n = len(data)
    outs = []

    def feed(lo, hi):
        for off in range(lo, hi, piece):
            outs.append(comp.compress(data[off : min(off + piece, hi)]))

    feed(0, n // 4)
    outs.append(comp.flush(zlib.Z_SYNC_FLUSH))
    feed(n // 4, n // 2)
    outs.append(comp.flush(zlib.Z_FULL_FLUSH))
    feed(n // 2, n // 2 + 1001)
    outs.append(comp.flush(zlib.Z_BLOCK))
    if not comp._tail_n:
        raise AssertionError("stream script: Z_BLOCK left no sub-byte tail")
    feed(n // 2 + 1001, 3 * n // 4 + 1001)
    outs.append(comp.set_params(level=9))
    feed(3 * n // 4 + 1001, n)
    outs.append(comp.flush(zlib.Z_FINISH))
    return outs


@contextlib.contextmanager
def capture(kernels, calls: dict):
    """Record every kernel wrapper's arguments while the body runs."""
    orig = {name: getattr(kernels, name) for name in KERNELS}

    def make(name):
        def wrapped(*args):
            calls.setdefault(name, []).append(args)
            return orig[name](*args)
        return wrapped

    for name in KERNELS:
        setattr(kernels, name, make(name))
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(kernels, name, fn)


class DeviceTimer:
    """Device time per call from CUDA events. The GPU first sleeps while
    the host queues every rep, so host launch overhead is not timed; an
    L2 flush precedes each rep, as the main path finds its inputs cold.
    The flush reads a 128 MB buffer (more than the 50 MB L2), so it leaves
    the L2 full of clean lines: the timed call pays no write-back of the
    previous call's outputs."""

    def __init__(self, torch):
        self.torch = torch
        self.buf = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")

    def flush(self) -> None:
        self.buf.max()

    def kernel_ms(self, fn, reps: int = 15) -> float:
        torch = self.torch
        fn()  # warm-up
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(20_000_000)
        for s, e in ev:
            self.flush()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)

    def phases_ms(self, phases, reps: int = 15) -> dict:
        """Median device time of each launch of a call made of several
        (name, launch) pairs, from events recorded between the launches;
        as in kernel_ms, the L2 is flushed before each call."""
        torch = self.torch

        def call(ev):
            ev[0].record()
            for k, (name, launch) in enumerate(phases):
                rc = launch()
                if rc:
                    raise RuntimeError(f"{name}: cudaError {rc}")
                ev[k + 1].record()

        call([torch.cuda.Event() for _ in range(len(phases) + 1)])
        torch.cuda.synchronize()
        evs = [[torch.cuda.Event(enable_timing=True)
                for _ in range(len(phases) + 1)] for _ in range(reps)]
        torch.cuda._sleep(20_000_000)
        for ev in evs:
            self.flush()
            call(ev)
        torch.cuda.synchronize()
        return {name: statistics.median(ev[k].elapsed_time(ev[k + 1])
                                        for ev in evs)
                for k, (name, _) in enumerate(phases)}

    def wall_ms(self, fn, reps: int = 3) -> float:
        """Event time of a call that launches many small ops (the plain
        versions): host gaps between its launches are part of its cost."""
        torch = self.torch
        fn()
        out = []
        for _ in range(reps):
            self.flush()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e))
        return statistics.median(out)


def max_abs_err(torch, a, b) -> int:
    if isinstance(a, tuple):
        return max(max_abs_err(torch, x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def seeded_inputs(torch, n: int, seed: int):
    """Seeded (BATCH, n) inputs of every kernel, made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def ri(lo, hi, shape=(BATCH, n)):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    adj = ri(0, 65)
    spos = torch.argsort(torch.rand((BATCH, n), generator=g, device=dev),
                         dim=1).int()
    ws = ri(0, 32769, (BATCH,))
    # Propagation: lengths up to 400 exercise the 512-wide window, a few up
    # to 65 535 the domain's edge. Row 0 is all matches. Row 1 holds only a
    # length of 514 at 100 (length 3 at k = 511: kept) and one of 515 at
    # 2000 (length 3 at k = 512, one past the window: not carried).
    mlen = torch.where(torch.rand((BATCH, n), generator=g, device=dev) < 0.4,
                       ri(3, 401), 0)
    mlen = torch.where(torch.rand((BATCH, n), generator=g, device=dev) < 0.02,
                       ri(3, 65536), mlen)
    mlen[0] = ri(3, 259, (n,))
    mlen[1] = 0
    mlen[1, 100] = 514
    mlen[1, 2000] = 515
    pk = torch.where(mlen > 0, (mlen << 15) | (32768 - ri(1, 32769)), 0).int()
    # Off the main-path shape: n not a multiple of 512 or of the tile, and
    # n % 4 == 3 (4-byte loads and stores).
    edge_pk = pk[:, : n - 1001].contiguous()
    step = torch.where(torch.rand((BATCH, n), generator=g, device=dev) < 0.3,
                       ri(3, 259), 1).int()
    starts = ri(0, 40000, (BATCH,))
    # Off the main-path shape: 570 rows per chunk (not a multiple of the
    # 32-row segment) and every chunk starting at 0.
    edge_step = step[:, : 570 * 512].contiguous()
    edge_starts = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
    return {
        "scan_candidates": [(adj, spos, ws, 16, 64, False),
                            (adj, spos, ws, 8, 16, True)],
        "propagate_matches": [(pk,), (edge_pk,)],
        "parse_rows": [(step, starts, 512), (edge_step, edge_starts, 512)],
    }


def phase_card(torch, kernels, native):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {name} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    path = kernels.build()
    log(f"build: {time.perf_counter() - t0:.3f} s -> {path.name}")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  ptxas {line.strip()}")
    t0 = time.perf_counter()
    native.lib()
    log(f"C runtime build: {time.perf_counter() - t0:.3f} s -> "
        f"{native.library_path().name}")
    return name, smi


def phase_kernels(torch, kernels, zt, timer, data):
    """Each kernel against its plain version at the main-path shape."""
    n = 32768 + MAIN_CHUNK
    real = {}
    for level, fmt in KERNEL_RUNS:
        calls: dict = {}
        with capture(kernels, calls):  # two batches, as on the main path
            zt.compress(data, level=level, format=fmt, chunk_bytes=MAIN_CHUNK)
        for name, args in calls.items():
            real.setdefault(name, []).extend((level, a) for a in args)
    # The stream's first full chunk: one encode_segments call on (1, n).
    calls = {}
    with capture(kernels, calls):
        zt.zlib_compat.compressobj(6, wbits=31).compress(data[:MAIN_CHUNK])
    stream_real = {name: args for name, args in calls.items()}
    plain = {
        "scan_candidates": kernels.scan_candidates_plain,
        "propagate_matches": kernels.propagate_matches_plain,
        "parse_rows": kernels.parse_rows_plain,
    }
    seeded = seeded_inputs(torch, n, seed=1)
    results = {}
    for name in KERNELS:
        kfn = getattr(kernels, name)
        err = 0
        checked = 0
        for _, args in real[name]:
            if tuple(args[0].shape) != (BATCH, n):
                raise AssertionError(f"{name}: shape {tuple(args[0].shape)}")
        for args in stream_real[name]:
            if tuple(args[0].shape) != (1, n):
                raise AssertionError(
                    f"{name}: stream shape {tuple(args[0].shape)}")
        for args in (seeded[name] + [a for _, a in real[name]]
                     + stream_real[name]):
            e = max_abs_err(torch, kfn(*args), plain[name](*args))
            torch.cuda.synchronize()
            if e:
                raise AssertionError(f"{name}: kernel != plain (max err {e})")
            err = max(err, e)
            checked += 1
        per_launch = []
        if name in ("scan_candidates", "propagate_matches"):
            per_launch = [launch_line(timer, kernels, name, kfn, level, args)
                          for level, args in real[name]]
        per_launch += [launch_line(timer, kernels, name, kfn, "stream_L6", a)
                       for a in stream_real[name]]
        # Time on the last real L6 launch (for the scan: order B, K=16).
        level, args = [la for la in real[name] if la[0] == 6][-1]
        if name == "parse_rows":
            _, phases = kernels.parse_rows_phases(*args)
            split = timer.phases_ms(phases)
            log("  parse_rows phases: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in split.items()))
        ms = timer.kernel_ms(lambda: kfn(*args))
        plain_ms = timer.wall_ms(lambda: plain[name](*args))
        bound_ms, bound_by, extra = bound(kernels, name, args)
        library_ms = None
        if name == "propagate_matches":
            library_ms = propagate_library_ms(torch, timer, args[0])
        results[name] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        }
        if per_launch:
            results[name]["per_launch"] = per_launch
        log(f"kernel {name}: {checked} comparisons exact; shape "
            f"{tuple(args[0].shape)}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by})"
            + (f", library {library_ms:.4f} ms" if library_ms else "")
            + extra)
    return results


def launch_line(timer, kernels, name, kfn, level, args) -> dict:
    """Time, bound and share of one real launch, printed and returned."""
    t = timer.kernel_ms(lambda: kfn(*args))
    b_ms, b_by, _ = bound(kernels, name, args)
    line = {"level": level, "shape": list(args[0].shape)}
    at = f"L{level}" if isinstance(level, int) else level
    if name == "scan_candidates":
        line.update(k_each=args[3], lcp_cap=args[4],
                    backward_only=bool(args[5]))
        what = (f"scan {at} K={args[3]} cap={args[4]} "
                f"{'backward' if args[5] else 'both ways'}")
    else:
        what = f"{name} {at}"
    what += f" {tuple(args[0].shape)}"
    line.update(ms=t, bound_ms=b_ms, bound_by=b_by, share=b_ms / t)
    log(f"  {what}: {t:.4f} ms, bound {b_ms * 1e3:.2f} us ({b_by}), share "
        f"{b_ms / t:.3f}")
    return line


def bound(kernels, name, args):
    """Least time for the call's work: max(bytes / HBM rate, ops / rate).
    Bytes: every input read once, every output written once. Ops: the
    32-bit compare/select work this call's data needs."""
    if name == "scan_candidates":
        adj, spos, ws, k_each, _cap, backward_only = args
        elems = adj.numel()
        nbytes = elems * 16 + ws.numel() * 4
        # Per element and neighbour-direction the function needs 3
        # operations on the integer pipe: the running min of the LCPs, one
        # compare for the one-range validity test (lo <= cpos <= p0 - 1,
        # unsigned), and one max of the packed key (m << 15) + cpos into
        # the best. Its two adds (cpos - lo, and the key's) can issue on
        # the FMA pipe as IMAD, 64 lanes per SM of its own, so they take
        # no integer-pipe time and, at 2 per 3, never bound alone.
        ops = elems * k_each * (1 if backward_only else 2) * 3
        extra = f"; K={k_each} {'backward' if backward_only else 'both ways'}"
    elif name == "propagate_matches":
        elems = args[0].numel()
        nbytes = elems * 8
        # The sliding-window max needs about 3 maxima per element (the
        # prefix, the suffix, and their join), then the gate's compare and
        # the final max: 5 integer-pipe operations. The offsets (u = pk -
        # (E - m) * 2^15, and back) are adds that can issue on the FMA pipe
        # as IMAD, which has 64 lanes of its own. Bytes bound it: 8 B per
        # element against 5 operations.
        ops = elems * 5
        extra = ""
    else:
        step, starts, row = args
        elems = step.numel()
        nbytes = elems * 8 + starts.numel() * 4
        rows_per = step.shape[1] // row
        # P1 walks every position; P3 only the committed ones.
        mark = kernels.parse_rows(*args)
        committed = int(mark.sum().item())
        ops = (elems + committed) * 4 + step.shape[0] * rows_per * 4
        # 32-row segments, rows cut into 8 parts (csrc/parse.cu); the last
        # segment chains the maps of those between it and the start's.
        w = row // 8
        seg0 = max(int(starts.min()), 0) // row // 32
        chain = max(-(-rows_per // 32) - seg0 - 2, 0)
        extra = (f"; serial shared-memory steps: exits {w} + 8 + 32, marks "
                 f"up to {chain} + {w} + 8 + {w}; {committed} committed of "
                 f"{elems}")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), extra


def propagate_library_ms(torch, timer, pk):
    """Yardstick: one max_pool1d over the 512-wide window of
    float64(pk + i * 2^15), left-padded outside the timed call."""
    import torch.nn.functional as F

    i = torch.arange(pk.shape[1], device=pk.device, dtype=torch.float64)
    u = torch.where(pk > 0, pk.double() + i * 32768.0, 0.0)
    x = F.pad(u, (511, 0))[:, None, :].contiguous()
    return timer.kernel_ms(lambda: F.max_pool1d(x, 512, stride=1))


def phase_main(torch, kernels, zt, profiling, data):
    """compress() on the 8 MiB corpus: L6 gzip, L1 zlib and L9 gzip."""
    ref = {}
    for zl in (6, 9):
        t0 = time.perf_counter()
        ref[zl] = len(zlib.compress(data, zl))
        zlib_s = time.perf_counter() - t0
        log(f"zlib-{zl} (host, one thread): {ref[zl]} B in {zlib_s:.4f} s "
            f"({len(data) / 1e6 / zlib_s:.2f} MB/s)")
    counts, rates = {}, {}
    for level, fmt in MAIN_RUNS:
        def run():
            return zt.compress(data, level=level, format=fmt,
                               chunk_bytes=MAIN_CHUNK)

        run()  # warm-up: first-call allocations and kernel loads
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = run()
        secs = [time.perf_counter() - t0]
        launched = dict(kernels.launches)
        back = gzip.decompress(out) if fmt == "gzip" else zlib.decompress(out)
        if back != data:
            raise AssertionError(f"L{level} {fmt}: output does not decode")
        if zt.decompress(out, format=fmt) != data:
            raise AssertionError(f"L{level} {fmt}: zt.decompress differs")
        idle = [k for k, v in launched.items() if v == 0]
        if idle:
            raise AssertionError(f"L{level}: kernels never launched: {idle}")
        for _ in range(MAIN_REPS - 1):
            t0 = time.perf_counter()
            if run() != out:
                raise AssertionError(f"L{level}: output differs between runs")
            secs.append(time.perf_counter() - t0)
        dt = statistics.median(secs)
        log(f"main L{level} {fmt}: {len(data)} -> {len(out)} B; median "
            f"{dt:.4f} s of {MAIN_REPS} calls (min {min(secs):.4f}, max "
            f"{max(secs):.4f}) = {len(data) / 1e6 / dt:.3f} MB/s; size vs "
            f"zlib-6 {len(out) / ref[6]:.5f}, vs zlib-9 "
            f"{len(out) / ref[9]:.5f}; decodes with stdlib and "
            f"zt.decompress; launches {launched}")
        with profiling.collect() as st:
            run()
        log(f"stages L{level} ms (each stage synchronises the card): "
            + json.dumps({k: round(v, 3) for k, v in st.as_ms().items()}))
        trace(torch, run, f"L{level}")
        counts[f"L{level}"] = launched
        rates[level] = len(data) / 1e6 / dt
    return counts, ref, rates


def trace(torch, run, what: str) -> None:
    """One profiled call: device time by kernel and the card's idle share
    of the call's wall time (kernels on one stream do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side events only: host ops also carry their kernels' time.
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    if not rows:
        log(f"trace {what}: no device time in the profile: not measured")
        return
    busy = sum(r[1] for r in rows)
    log(f"trace {what}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.4f}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {us / 1e3:9.3f} ms {count:6d}x {key[:90]}")


def phase_stream(torch, kernels, zt, profiling, data, zlib6: int,
                 oneshot_mbps: float):
    """The 8 MiB corpus streamed through zlib_compat on the card."""
    def run():
        co = zt.zlib_compat.compressobj(6, wbits=31)
        out = bytearray()
        for off in range(0, len(data), STREAM_PIECE):
            out += co.compress(data[off : off + STREAM_PIECE])
        out += co.flush(zlib.Z_FINISH)
        return bytes(out)

    run()  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = run()
    secs = [time.perf_counter() - t0]
    launched = dict(kernels.launches)
    if gzip.decompress(out) != data:
        raise AssertionError("stream: output does not decode with gzip")
    idle = [k for k, v in launched.items() if v == 0]
    if idle:
        raise AssertionError(f"stream: kernels never launched: {idle}")
    for _ in range(STREAM_REPS - 1):
        t0 = time.perf_counter()
        if run() != out:
            raise AssertionError("stream: output differs between runs")
        secs.append(time.perf_counter() - t0)
    dt = statistics.median(secs)
    nchunks = -(-len(data) // MAIN_CHUNK)
    log(f"stream L6 gzip ({STREAM_PIECE} B pieces, {nchunks} chunks of "
        f"{MAIN_CHUNK}, one (1, {32768 + MAIN_CHUNK}) batch each): "
        f"{len(data)} -> {len(out)} B; median {dt:.4f} s of {STREAM_REPS} "
        f"calls (min {min(secs):.4f}, max {max(secs):.4f}) = "
        f"{len(data) / 1e6 / dt:.3f} MB/s against the one-shot L6 gzip's "
        f"{oneshot_mbps:.3f} MB/s; size vs zlib-6 {len(out) / zlib6:.5f}; "
        f"launches {launched}")
    with profiling.collect() as st:
        run()
    log("stages stream L6 ms (each stage synchronises the card): "
        + json.dumps({k: round(v, 3) for k, v in st.as_ms().items()}))
    trace(torch, run, "stream L6")

    secs = []
    for _ in range(STREAM_REPS):
        d = zt.stream.Decompressor(format="gzip")
        back = bytearray()
        t0 = time.perf_counter()
        for off in range(0, len(out), STREAM_PIECE):
            back += d.decompress(out[off : off + STREAM_PIECE])
        back += d.flush()
        secs.append(time.perf_counter() - t0)
        if bytes(back) != data or not d.eof:
            raise AssertionError("stream: Decompressor does not give the input")
    dt = statistics.median(secs)
    log(f"host stream.Decompressor (C inflate on the host, not the card), "
        f"{STREAM_PIECE} B pieces: median {dt:.4f} s of {STREAM_REPS} = "
        f"{len(data) / 1e6 / dt:.3f} MB/s of output")

    buf = io.BytesIO()
    t0 = time.perf_counter()
    with zt.gzip_compat.GzipFile(fileobj=buf, mode="wb", compresslevel=6,
                                 mtime=0, engine="device") as f:
        for off in range(0, len(data), 1 << 20):
            f.write(data[off : off + (1 << 20)])
    dt = time.perf_counter() - t0
    if gzip.decompress(buf.getvalue()) != data:
        raise AssertionError("GzipFile on the card: output does not decode")
    log(f"gzip_compat.GzipFile(engine='device', level 6), 1 MiB writes: "
        f"{len(buf.getvalue())} B in {dt:.4f} s ({len(data) / 1e6 / dt:.3f} "
        f"MB/s, one call); decodes with stdlib gzip")
    return launched


def phase_reference(torch, zt, data, corpus):
    prefix = data[: 1 << 20]
    ref_in = corpus.mixed_corpus(REF_INPUT_BYTES, REF_INPUT_SEED)
    for level, want in ((6, REF_SHA256_L6_4K), (9, REF_SHA256_L9_4K)):
        gpu = zt.compress(prefix, level=level, format="gzip")
        cpu = zt.compress(prefix, level=level, format="gzip", device="cpu")
        if gpu != cpu:
            raise AssertionError(
                f"L{level} 1 MiB prefix: card bytes != CPU-path bytes")
        digest = hashlib.sha256(
            zt.compress(ref_in, level=level, chunk_bytes=4096)
        ).hexdigest()
        if digest != want:
            raise AssertionError(f"REF_SHA256_L{level}_4K mismatch: {digest}")
        log(f"reference L{level}: 1 MiB prefix card == CPU path ({len(gpu)} "
            f"B); 64 KiB L{level}/4K sha256 {digest} == REF_SHA256_L{level}_4K")
    gpu = stream_script(zt.stream.Compressor(level=6, format="gzip"), prefix,
                        STREAM_PIECE)
    cpu = stream_script(zt.stream.Compressor(level=6, format="gzip",
                                             device="cpu"),
                        prefix, STREAM_PIECE)
    if gpu != cpu:
        bad = [i for i, (a, b) in enumerate(zip(gpu, cpu)) if a != b]
        raise AssertionError(f"stream script: card != CPU path at calls {bad}")
    if gzip.decompress(b"".join(gpu)) != prefix:
        raise AssertionError("stream script: output does not decode")
    blob = b"".join(stream_script(
        zt.stream.Compressor(level=6, format="gzip", chunk_bytes=4096),
        ref_in, 4096))
    digest = hashlib.sha256(blob).hexdigest()
    if digest != REF_SHA256_STREAM_4K:
        raise AssertionError(f"REF_SHA256_STREAM_4K mismatch: {digest}")
    log(f"reference stream: 1 MiB prefix script card == CPU path on all "
        f"{len(gpu)} calls ({sum(map(len, gpu))} B); 64 KiB/4K script sha256 "
        f"{digest} == REF_SHA256_STREAM_4K")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import zzflate_tpu_torch as zt
    from zzflate_tpu_torch import native
    from zzflate_tpu_torch.ops import kernels
    from zzflate_tpu_torch.utils import corpus, profiling

    name, smi = phase_card(torch, kernels, native)
    data = corpus.mixed_corpus(MAIN_BYTES, seed=0)
    timer = DeviceTimer(torch)
    results = phase_kernels(torch, kernels, zt, timer, data)
    counts, ref, rates = phase_main(torch, kernels, zt, profiling, data)
    counts["stream_L6"] = phase_stream(torch, kernels, zt, profiling, data,
                                       ref[6], rates[6])
    phase_reference(torch, zt, data, corpus)

    line = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts["L6"][k],
         "launches_by_level": {lv: c[k] for lv, c in counts.items()},
         **results[k]}
        for k, (src, rep) in KERNELS.items()
    ]}
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
