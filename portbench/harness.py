"""Run one cell of ``BENCHMARK.json`` once: set-up, warm-up, the measured
window and the comparison with the plain reference; then the result.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by its name: ``portbench/configs/<config>.json``;
``portbench/traffic/<mix>.json``, with the kind of call, the data source
and the container it names (``portbench/kinds/<kind>.py``,
``portbench/data/<source>.py``, ``portbench/formats/<format>.py``; see
``generator``); and ``portbench/metrics/<metric>.py`` (a ``read(rec)``
that returns the metric's value, or None when it finds nothing to read).

A window is a closed loop with one client: each call waits for the one
before it, from the window's start until ``seconds`` have passed; the
last call started in time runs to its end, and the window ends with it.
A traced run profiles the window's first calls (``PROFILE_S``, at least
``PROFILE_CALLS`` after one uncounted call) and times the program's
stages over the rest.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import sys
import time
import traceback
from pathlib import Path

import torch

from portbench import generator, trace

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "zzflate_tpu")  # top-level names
PROFILE_S = 2.0
PROFILE_CALLS = 2
MIB = float(1 << 20)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(root: Path, folder: str, name: str):
    """portbench/<folder>/<name>.py under root, as a module of its own."""
    path = root / "portbench" / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(root)}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reports(metric: dict, cell: str, spec: dict) -> bool:
    """Whether `cell` reports `metric`: the cells its `workloads` lists;
    without that key every cell for an end-to-end metric, and for a
    per-layer one every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" not in metric:
        return True
    moved = next(m for m in spec["end_to_end"] if m["name"] == metric["moves"])
    return reports(moved, cell, spec)


def resolve(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, its configuration and traffic; the modules of the
    traffic's kind, its data source and the configuration's format; and
    the metrics it reports (end to end and per layer), each with its
    reader."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = load_json(root / cfg["file"])
    traffic = load_json(root / "portbench" / "traffic"
                        / f"{cell['traffic']}.json")
    out = {"cell": cell, "config": config, "traffic": traffic,
           "kind": load_module(root, "kinds", traffic["kind"]),
           "data": load_module(root, "data", traffic["data"]).make,
           "format": load_module(root, "formats", config["codec"]["format"])}
    for kind in ("end_to_end", "per_layer"):
        out[kind] = [(m, load_module(root, "metrics", m["name"]).read)
                     for m in spec[kind] if reports(m, workload, spec)]
    return out


def make_traffic(cell: dict, seed: int, device, overrides: dict | None
                 = None):
    """The cell's Traffic (its kind's class) with the keys of `overrides`
    ({"traffic": ..., "codec": ...}) replacing the mix's and the
    configuration's: the CPU tests' small sizes."""
    ov = overrides or {}
    mix = dict(cell["traffic"], **ov.get("traffic", {}))
    codec = dict(cell["config"]["codec"], **ov.get("codec", {}))
    return cell["kind"].Traffic(mix, codec, seed, device, cell["data"],
                                cell["format"])


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (zzflate_tpu_torch is not zzflate_tpu)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


class GcClock:
    """Runs of the interpreter's cyclic collector by generation, and the
    seconds they took, while active."""

    def __init__(self):
        self.runs = [0, 0, 0]
        self.s = 0.0
        self._t0 = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.s += time.perf_counter() - self._t0
            self.runs[info["generation"]] += 1
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)


class Window:
    """The calls of one window: (start, end, bytes in, bytes out)."""

    def __init__(self, traffic: generator.Traffic):
        self.traffic = traffic
        self.calls: list[tuple[float, float, int, int]] = []
        self.failed = 0
        self.first_error = None
        self.start = self.end = time.perf_counter()

    def call(self) -> None:
        i = len(self.calls)
        t0 = time.perf_counter()
        try:
            n_in, n_out = self.traffic.call(i)
        except Exception:  # a failed call counts; the window goes on
            self.failed += 1
            n_in = n_out = 0
            if self.first_error is None:
                self.first_error = traceback.format_exc()
        t1 = time.perf_counter()
        self.calls.append((t0, t1, n_in, n_out))
        self.end = t1

    def mib(self, calls) -> tuple[float, float]:
        return (sum(c[2] for c in calls) / MIB, sum(c[3] for c in calls) / MIB)


def plain_window(w: Window, seconds: float) -> dict:
    deadline = w.start + seconds
    while not w.calls or time.perf_counter() < deadline:
        w.call()
    return {}


def traced_window(w: Window, seconds: float) -> dict:
    """Profile the first calls, then time stages over the rest."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if w.traffic.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    deadline = w.start + seconds
    with trace.stage_ranges(), profile(activities=acts) as prof:
        w.call()  # the session's first call: not counted
        first = len(w.calls)
        t_prof = time.perf_counter()
        while (len(w.calls) - first < PROFILE_CALLS
               or time.perf_counter() < t_prof + min(PROFILE_S, seconds / 3)):
            with record_function(trace.CALL):
                w.call()
    counted = range(first, len(w.calls))
    left = deadline - time.perf_counter()
    t_read = time.perf_counter()
    events = trace.profiled_events(prof)
    del prof
    prof_rec = trace.read_profile(events, [w.traffic.bound_ms(i)
                                           for i in counted],
                                  w.traffic.FAMILIES)
    prof_rec["in_mib"], prof_rec["out_mib"] = w.mib(
        [w.calls[i] for i in counted])
    t_read = time.perf_counter() - t_read
    print(f"profile: {len(counted)} calls, {len(events)} events, read in "
          f"{t_read:.1f} s", file=sys.stderr)
    spans = trace.StageSpans()
    b0 = len(w.calls)
    deadline = time.perf_counter() + left  # reading the trace is not window
    with spans.activate() as timer:
        while len(w.calls) == b0 or time.perf_counter() < deadline:
            w.call()
    tail = w.calls[b0:]
    in_mib, out_mib = w.mib(tail)
    return {"profile": prof_rec,
            "stages": {"in_mib": in_mib, "out_mib": out_mib,
                       "stages_ms": timer.as_ms(),
                       "self_ms": 1e3 * sum(spans.self_s(a, b)
                                            for a, b, _i, _o in tail)}}


def _quartiles(ms: list[float]) -> str:
    q = statistics.quantiles(ms, n=4) if len(ms) > 1 else ms * 3
    return " ".join(f"{x:.3f}" for x in q)


def _log_window(w: Window, gcc: GcClock) -> None:
    """The window's calls on standard error: their time's quartiles, in
    all and by buffer of the pool; the MB/s in and out of each half of
    the window; the collector's runs: for telling noise inside a run from
    noise between runs."""
    ms = [(b - a) * 1e3 for a, b, _i, _o in w.calls]
    npool = len(w.traffic.pool)
    by_buf = "; ".join(f"{j}: {_quartiles(ms[j::npool])}"
                       for j in range(min(npool, len(ms))))
    mid = (w.start + w.end) / 2
    halves = []
    for part in ([c for c in w.calls if c[1] <= mid],
                 [c for c in w.calls if c[1] > mid]):
        span = (part[-1][1] - part[0][0]) if part else 0.0
        n_in, n_out = w.mib(part)
        halves.append(f"{n_in * MIB / 1e6 / span:.3f}/"
                      f"{n_out * MIB / 1e6 / span:.3f}" if span else "-")
    print(f"window: {len(ms)} calls in {w.end - w.start:.3f} s, call ms "
          f"quartiles {_quartiles(ms)}, by buffer {by_buf}; MB/s in/out by "
          f"half: {halves[0]}, {halves[1]}; collector runs {gcc.runs} in "
          f"{gcc.s:.3f} s", file=sys.stderr)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             root: Path = ROOT, device: str = "cuda", t_start: float | None
             = None, overrides: dict | None = None) -> dict:
    """One run of a cell; returns the result line's object, without the
    import check (the caller's, once everything has run). overrides: see
    make_traffic."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = resolve(workload, root)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    traffic = make_traffic(cell, seed, dev, overrides)
    traffic.setup()
    traffic.warm()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    w = Window(traffic)
    setup_s = w.start - t_start
    with GcClock() as gcc:
        rec = (traced_window if traced else plain_window)(w, seconds)
    if traced and dev.type == "cuda" and not rec["profile"]["device_events"]:
        raise RuntimeError("the profile of the traced calls holds no device "
                           "event")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec.update(calls=w.calls, failed=w.failed, window_s=w.end - w.start,
               setup_s=setup_s)
    if not traced:  # a traced window also holds the trace's reading
        _log_window(w, gcc)
    checks = traffic.check(w.failed)
    metrics = {}
    for m, read in cell["per_layer" if traced else "end_to_end"]:
        value = read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_rec = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                  "count": 1, "memory_peak_bytes": peak}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": len(w.calls), "failed": w.failed,
              "metrics": metrics, "device": device_rec}
    if traced:
        device_rec["busy_s"] = rec["profile"]["busy_s"]
        device_rec["window_s"] = rec["profile"]["window_s"]
        result["breakdown"] = rec["profile"]["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    if w.first_error is not None:
        print(f"first failed call:\n{w.first_error}", file=sys.stderr)
    return result
