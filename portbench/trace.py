"""What the traced run reads: the device timeline of torch.profiler over
calls after warm-up, and the program's stage spans
(``utils/profiling.collect``).

The profile is kept in memory. Only the CUDA events inside the profiled
calls' ranges count: a fresh profiler session can miss a call's first
launches, so the session's first call is not counted.
"""
from __future__ import annotations

import collections
import contextlib
import re
import threading
import time

CALL = "portbench.call"
STAGE = "stage:"
_OWN = ("portbench.", STAGE, "ProfilerStep")  # ranges mirrored on the card

# The program's kernels by family, as their names show on the device
# timeline: the encoders' matcher kernels (bounds.encode_families) and the
# per-bit decode's kernels (bounds.decode_families). A kind names the
# families its calls run (generator.Traffic.FAMILIES); a kind with a
# kernel of its own adds a family there, with its bound.
ENCODE_FAMILIES = {
    "scan": ("scan_kernel",),
    "propagate": ("propagate_kernel",),
    "parse": ("parse_exit_kernel", "parse_mark_kernel"),
}
DECODE_FAMILIES = {
    "candidates": ("unit_bounds_kernel", "candidates_kernel"),
    "commit": ("commit_rows_kernel", "commit_chain_kernel",
               "commit_marks_kernel"),
    "scatter": ("token_scatter_kernel",),
    "resolve": ("resolve_tile_max_kernel", "resolve_carry_kernel",
                "resolve_hop_kernel", "resolve_round_kernel",
                "resolve_gather_kernel"),
    "crc": ("crc_blocks_kernel", "crc_rows_kernel"),
}
TOP = 10  # entries of each breakdown list
NAME_CHARS = 160  # of a kernel's name in the breakdown (templates run long)


def family_matcher(families: dict):
    """name -> its family in `families`, or None."""
    rxs = {f: re.compile(r"\b(" + "|".join(names) + r")\b")
           for f, names in families.items()}

    def family_of(name: str) -> str | None:
        for fam, rx in rxs.items():
            if rx.search(name):
                return fam
        return None
    return family_of


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals, lo: float, hi: float) -> float:
    """Length of [lo, hi] that the union of `intervals` covers."""
    clipped = [(max(a, lo), min(b, hi)) for a, b in intervals]
    return sum(b - a for a, b in _union((a, b) for a, b in clipped if b > a))


@contextlib.contextmanager
def stage_hook(make):
    """Activate the program's stage collector with each stage opened
    through make(original stage method) instead of the method itself."""
    from zzflate_tpu_torch.utils import profiling

    with profiling.collect() as timer:
        timer.stage = make(timer.stage)
        yield timer


def stage_ranges():
    """Each stage as a profiler range, with no synchronisation: in the
    profiled calls it labels what the host was doing."""
    import torch

    return stage_hook(lambda _orig: lambda name, device=None:
                      torch.profiler.record_function(STAGE + name))


class StageSpans:
    """Each stage's (name, start, end) on the host clock, timed by the
    program's own stage method (which synchronises the cards it names)."""

    def __init__(self):
        self.spans: list[tuple[str, float, float]] = []
        self._lock = threading.Lock()

    def activate(self):
        def make(orig):
            @contextlib.contextmanager
            def stage(name, device=None):
                t0 = time.perf_counter()
                with orig(name, device):
                    yield
                with self._lock:
                    self.spans.append((name, t0, time.perf_counter()))
            return stage
        return stage_hook(make)

    def self_s(self, lo: float, hi: float) -> float:
        """Seconds of [lo, hi] that no stage covers."""
        with self._lock:
            iv = [(a, b) for _n, a, b in self.spans]
        return (hi - lo) - covered(iv, lo, hi)


def read_profile(events, bound_ms_per_call: list[dict], families: dict
                 ) -> dict:
    """Reduce the profiler's events of the counted calls.

    events: (name, on the device, thread, start us, end us) tuples.
    bound_ms_per_call: each counted call's least ms by kernel family.
    families: the kernel names of each family (generator.Traffic.FAMILIES).
    Returns busy_s and window_s (the counted calls' span), the kernel
    launches, device ms by family, the families' bounds, and the
    breakdown's two lists; device_events 0 when the profile holds none."""
    calls = [(a, b, th) for n, dev, th, a, b in events
             if not dev and n == CALL]
    if not calls:
        raise RuntimeError("the profile holds no counted call")
    lo = min(a for a, _b, _t in calls)
    hi = max(b for _a, b, _t in calls)
    main = collections.Counter(th for _a, _b, th in calls).most_common(1)[0][0]
    dev = [(n, max(a, lo), min(b, hi)) for n, d, _th, a, b in events
           if d and not n.startswith(_OWN) and b > lo and a < hi]
    busy = _union((a, b) for _n, a, b in dev)
    ops = collections.defaultdict(float)
    fam_us = collections.defaultdict(float)
    launches = 0
    family_of = family_matcher(families)
    for n, a, b in dev:
        ops[n] += b - a
        if not n.startswith(("Memcpy", "Memset")):
            launches += 1
            fam = family_of(n)
            if fam is not None:
                fam_us[fam] += b - a
    stages = [(n[len(STAGE):], a, b, th) for n, d, th, a, b in events
              if not d and n.startswith(STAGE)]
    gaps = collections.defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[_host_label((a + b) / 2, stages, calls, main)] += b - a
    bound = collections.defaultdict(float)
    for per_call in bound_ms_per_call:
        for fam, ms in per_call.items():
            bound[fam] += ms
    unbounded = set(fam_us) - set(bound)
    if unbounded:
        raise RuntimeError(f"kernel families ran with no bound: {unbounded}")
    top = lambda d: [[k[:NAME_CHARS], v / 1e6] for k, v in  # noqa: E731
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "window_s": (hi - lo) / 1e6, "device_events": len(dev),
            "launches": launches,
            "family_ms": {k: v / 1e3 for k, v in fam_us.items()},
            "family_bound_ms": dict(bound),
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(gaps)}}


def _host_label(t: float, stages, calls, main) -> str:
    """What the host was doing at time t: the innermost stage running
    then (the calling thread's first), else whether a call was open."""
    open_ = [(a, th, n) for n, a, b, th in stages if a <= t <= b]
    if open_:
        mine = [s for s in open_ if s[1] == main] or open_
        return "stage " + max(mine)[2]
    if any(a <= t <= b for a, b, _th in calls):
        return "call, in no stage"
    return "between calls"


def profiled_events(prof) -> list[tuple]:
    """The profiler's events as plain tuples (no profiler object outlives
    the session)."""
    return [(e.name, str(e.device_type).endswith("CUDA"), e.thread,
             e.time_range.start, e.time_range.end) for e in prof.events()]
