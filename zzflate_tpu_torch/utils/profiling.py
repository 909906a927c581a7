"""Per-stage wall times of the encode pipeline.

Port of ``zzflate_tpu/utils/profiling.py:58-80`` (``collect``,
``maybe_stage``, ``StageTimer``). Eager CUDA returns before the device
finishes, so a stage on a CUDA device synchronises that device before
it stops its timer. The synchronisation happens only while a collector
is active; with none, ``maybe_stage`` costs nothing.

    with profiling.collect() as t:
        zzflate_tpu_torch.compress(data)
    print(t.as_ms())
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

_current: "StageTimer | None" = None


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


@contextlib.contextmanager
def maybe_stage(name: str, device: torch.device | None = None):
    """Record a stage on the active collector, if any."""
    t = _current
    if t is None:
        yield
    else:
        with t.stage(name, device):
            yield


class StageTimer:
    def __init__(self):
        self.stages: dict[str, float] = {}
        self._lock = threading.Lock()  # stages run on two threads

    @contextlib.contextmanager
    def stage(self, name: str, device: torch.device | None = None):
        t0 = time.perf_counter()
        yield
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        with self._lock:
            self.stages[name] = self.stages.get(name, 0.0) + dt

    def as_ms(self) -> dict[str, float]:
        with self._lock:
            return {k: v * 1e3 for k, v in self.stages.items()}
