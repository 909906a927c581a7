"""Per-stage wall times of the encode pipeline and device decode, and
traces.

Port of ``zzflate_tpu/utils/profiling.py`` (``trace``, ``collect``,
``maybe_stage``, ``StageTimer``), and ``DeviceTimer``, the CUDA-event
timing that chip_smoke.py and the bench scripts use. Eager CUDA returns
before the device finishes, so a stage on CUDA devices synchronises
each of them before it stops its timer. The synchronisation happens
only while a collector is active. While a torch.profiler session runs,
each stage is also a ``"stage:" + name`` range on the profiler's clock,
with or without a collector; with neither, ``maybe_stage`` returns one
shared null context.

    with profiling.collect() as t:
        zzflate_tpu_torch.compress(data)
    print(t.as_ms())
"""
from __future__ import annotations

import contextlib
import os
import statistics
import threading
import time

import torch

_current: "StageTimer | None" = None
_NULL = contextlib.nullcontext()
STAGE_PREFIX = "stage:"  # of a stage's range in a profile


def _profile_range(name: str):
    """The stage's profiler range while a profiler runs, else _NULL."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(STAGE_PREFIX + name)
    return _NULL


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a region (host and CUDA activity) and write a gzipped
    Chrome trace into `logdir` (view with Perfetto or chrome://tracing);
    yields the profiler, whose key_averages() the caller may read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    name = f"trace_{os.getpid()}_{time.time_ns()}.json.gz"
    prof.export_chrome_trace(os.path.join(logdir, name))


@contextlib.contextmanager
def collect():
    """Activate per-stage timing for the encode pipeline."""
    global _current
    t = StageTimer()
    prev, _current = _current, t
    try:
        yield t
    finally:
        _current = prev


def maybe_stage(name: str, device=None):
    """A context that records a stage on the active collector, if any,
    else opens its profiler range while a profiler runs. `device` is a
    torch.device or a list of them (a mesh may name one twice)."""
    t = _current
    if t is not None:
        return t.stage(name, device)
    return _profile_range(name)


def _cuda_devices(device) -> list[torch.device]:
    devs = device if isinstance(device, (list, tuple)) else [device]
    out = []
    for d in devs:
        if d is not None and d.type == "cuda" and d not in out:
            out.append(d)
    return out


class StageTimer:
    def __init__(self):
        self.stages: dict[str, float] = {}
        self._lock = threading.Lock()  # stages run on two threads

    @contextlib.contextmanager
    def stage(self, name: str, device=None):
        t0 = time.perf_counter()
        with _profile_range(name):
            yield
            for d in _cuda_devices(device):
                torch.cuda.synchronize(d)
        dt = time.perf_counter() - t0
        with self._lock:
            self.stages[name] = self.stages.get(name, 0.0) + dt

    def as_ms(self) -> dict[str, float]:
        with self._lock:
            return {k: v * 1e3 for k, v in self.stages.items()}


class DeviceTimer:
    """Device time per call from CUDA events. The GPU first sleeps while
    the host queues every rep, so host launch overhead is not timed; an
    L2 flush precedes each rep, as the main path finds its inputs cold.
    The flush reads a 128 MB buffer (more than the 50 MB L2), so it leaves
    the L2 full of clean lines: the timed call pays no write-back of the
    previous call's outputs."""

    def __init__(self):
        self.buf = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")

    def flush(self) -> None:
        self.buf.max()

    def kernel_ms(self, fn, reps: int = 15) -> float:
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
