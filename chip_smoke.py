#!/usr/bin/env python3
"""Drive the zzflate_tpu_torch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing is caught):

1. card: the device name, nvidia-smi's name and power limit, and the
   nvcc build of the three kernels from zzflate_tpu_torch/csrc;
2. kernels: at the main-path shape (16, 294912) each kernel is held
   against its plain torch version on the card, on seeded inputs and on
   the arrays a real L6 and L1 batch hand it; equality must be exact (the
   codec is integer-only). Device times: the kernel, the plain version,
   the bound, and for propagate_matches a library yardstick;
3. main path: compress() on a seeded 8 MiB corpus at level 6 gzip and
   level 1 zlib with 256 KiB chunks; each output must decode with stdlib
   zlib to the input, and every kernel must have launched (counts reset
   just before the first timed call, read just after). The median time
   of MAIN_REPS calls, MB/s, size against zlib level 6, stage times
   (a separate run) and a torch.profiler trace (another run: device time
   by kernel, the card's idle share) are printed;
4. reference bytes: a 1 MiB prefix on the card equals the port's CPU
   path, and a fixed 64 KiB input at level 6 with 4 KiB chunks hashes to
   REF_SHA256_L6_4K, the digest the JAX reference produces (asserted by
   tests/test_torch_api.py).

The second-to-last lines are the kernels JSON and nvidia-smi's line; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import gzip
import hashlib
import json
import statistics
import subprocess
import sys
import time
import zlib

MAIN_BYTES = 8 << 20
MAIN_CHUNK = 1 << 18
MAIN_REPS = 5  # timed compress() calls per level
BATCH = 16  # chunks per device batch on the main path
REF_INPUT_BYTES = 1 << 16
REF_INPUT_SEED = 7
REF_SHA256_L6_4K = "5fb898053468dc47e80f13c50044f253ad40d6dc18c3b0f6b6d19f4149f7f15e"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate

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
    L2 flush precedes each rep, as the main path finds its inputs cold."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def kernel_ms(self, fn, reps: int = 15) -> float:
        torch = self.torch
        fn()  # warm-up
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(20_000_000)
        for s, e in ev:
            self.flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)

    def wall_ms(self, fn, reps: int = 3) -> float:
        """Event time of a call that launches many small ops (the plain
        versions): host gaps between its launches are part of its cost."""
        torch = self.torch
        fn()
        out = []
        for _ in range(reps):
            self.flush.zero_()
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
    # Lengths up to 400 exercise the 512-wide propagation window.
    mlen = torch.where(torch.rand((BATCH, n), generator=g, device=dev) < 0.4,
                       ri(3, 401), 0)
    pk = torch.where(mlen > 0, (mlen << 15) | (32768 - ri(1, 32769)), 0)
    step = torch.where(torch.rand((BATCH, n), generator=g, device=dev) < 0.3,
                       ri(3, 259), 1).int()
    starts = ri(0, 40000, (BATCH,))
    return {
        "scan_candidates": [(adj, spos, ws, 16, 64, False),
                            (adj, spos, ws, 8, 16, True)],
        "propagate_matches": [(pk.int().contiguous(),)],
        "parse_rows": [(step, starts, 512)],
    }


def phase_card(torch, kernels):
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
    return name, smi


def phase_kernels(torch, kernels, zt, timer, data):
    """Each kernel against its plain version at the main-path shape."""
    n = 32768 + MAIN_CHUNK
    real = {}
    for level in (6, 1):
        calls: dict = {}
        with capture(kernels, calls):
            zt.compress(data[: BATCH * MAIN_CHUNK], level=level,
                        chunk_bytes=MAIN_CHUNK)
        for name, args in calls.items():
            real.setdefault(name, []).extend((level, a) for a in args)
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
        for args in seeded[name] + [a for _, a in real[name]]:
            if tuple(args[0].shape) != (BATCH, n):
                raise AssertionError(f"{name}: shape {tuple(args[0].shape)}")
            e = max_abs_err(torch, kfn(*args), plain[name](*args))
            torch.cuda.synchronize()
            if e:
                raise AssertionError(f"{name}: kernel != plain (max err {e})")
            err = max(err, e)
            checked += 1
        if name == "scan_candidates":
            for level, args in real[name]:
                log(f"  scan L{level} K={args[3]} cap={args[4]} "
                    f"{'backward' if args[5] else 'both ways'}: "
                    f"{timer.kernel_ms(lambda: kfn(*args)):.4f} ms")
        # Time on the real L6 batch's call (for the scan: order B, K=16).
        level, args = [la for la in real[name] if la[0] == 6][-1]
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
        log(f"kernel {name}: {checked} comparisons exact; shape "
            f"{tuple(args[0].shape)}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by})"
            + (f", library {library_ms:.4f} ms" if library_ms else "")
            + extra)
    return results


def bound(kernels, name, args):
    """Least time for the call's work: max(bytes / HBM rate, ops / rate).
    Bytes: every input read once, every output written once. Ops: the
    32-bit compare/select work this call's data needs."""
    if name == "scan_candidates":
        adj, spos, ws, k_each, _cap, backward_only = args
        elems = adj.numel()
        nbytes = elems * 16 + ws.numel() * 4
        ops = elems * k_each * (1 if backward_only else 2) * 8
        extra = f"; K={k_each} {'backward' if backward_only else 'both ways'}"
    elif name == "propagate_matches":
        elems = args[0].numel()
        nbytes = elems * 8
        ops = elems * 9 * 5  # nine rounds of sub, two gates, max
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
        extra = (f"; serial steps {row} + {rows_per} + {row}; "
                 f"{committed} committed of {elems}")
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
    """compress() on the 8 MiB corpus: L6 gzip and L1 zlib."""
    t0 = time.perf_counter()
    ref6 = zlib.compress(data, 6)
    zlib_s = time.perf_counter() - t0
    log(f"zlib-6 (host, one thread): {len(ref6)} B in {zlib_s:.4f} s "
        f"({len(data) / 1e6 / zlib_s:.2f} MB/s)")
    counts = {}
    for level, fmt in ((6, "gzip"), (1, "zlib")):
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
            f"zlib-6 {len(out) / len(ref6):.5f}; decodes with stdlib; "
            f"launches {launched}")
        with profiling.collect() as st:
            run()
        log(f"stages L{level} ms (each stage synchronises the card): "
            + json.dumps({k: round(v, 3) for k, v in st.as_ms().items()}))
        trace(torch, run, level)
        counts[level] = launched
    return counts


def trace(torch, run, level: int) -> None:
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
        log(f"trace L{level}: no device time in the profile: not measured")
        return
    busy = sum(r[1] for r in rows)
    log(f"trace L{level}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.4f}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {us / 1e3:9.3f} ms {count:6d}x {key[:90]}")


def phase_reference(torch, zt, data, corpus):
    prefix = data[: 1 << 20]
    gpu = zt.compress(prefix, level=6, format="gzip")
    cpu = zt.compress(prefix, level=6, format="gzip", device="cpu")
    if gpu != cpu:
        raise AssertionError("1 MiB prefix: card bytes != CPU-path bytes")
    ref_in = corpus.mixed_corpus(REF_INPUT_BYTES, REF_INPUT_SEED)
    digest = hashlib.sha256(
        zt.compress(ref_in, level=6, chunk_bytes=4096)
    ).hexdigest()
    if digest != REF_SHA256_L6_4K:
        raise AssertionError(f"REF_SHA256_L6_4K mismatch: {digest}")
    log(f"reference: 1 MiB prefix card == CPU path ({len(gpu)} B); "
        f"64 KiB L6/4K sha256 {digest} == REF_SHA256_L6_4K")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import zzflate_tpu_torch as zt
    from zzflate_tpu_torch.ops import kernels
    from zzflate_tpu_torch.utils import corpus, profiling

    name, smi = phase_card(torch, kernels)
    data = corpus.mixed_corpus(MAIN_BYTES, seed=0)
    timer = DeviceTimer(torch)
    results = phase_kernels(torch, kernels, zt, timer, data)
    counts = phase_main(torch, kernels, zt, profiling, data)
    phase_reference(torch, zt, data, corpus)

    line = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[6][k], **results[k]}
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
