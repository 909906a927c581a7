"""Arithmetic shared by the metric readers in ``portbench/metrics``.

A reader gets the run's record: ``calls`` ((start, end, bytes in, bytes
out) per call of the window), ``window_s``, ``setup_s`` and ``failed``;
a traced run adds ``profile`` (``trace.read_profile`` over the profiled
calls, with their MiB in and out) and ``stages`` (the program's stage
milliseconds over the calls after them, their MiB in and out, and the
milliseconds of those calls that no stage covers). Per-MiB metrics
count MiB of input for the encoder and MiB of output for the decoder.
"""
from __future__ import annotations

import statistics


def rate_MBps(rec: dict, field: int) -> float:
    """10^6 bytes (field 2: handed in, 3: handed back) over the window."""
    return sum(c[field] for c in rec["calls"]) / 1e6 / rec["window_s"]


def call_percentile_ms(rec: dict, pct: int) -> float:
    ms = [(c[1] - c[0]) * 1e3 for c in rec["calls"]]
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=100, method="inclusive")[pct - 1]


def stages_per_mib(rec: dict, names, per: str) -> float | None:
    """Milliseconds of the named stages per MiB (per: "in_mib" or
    "out_mib"); None when none of them ran."""
    st = rec.get("stages")
    if not st or not st[per]:
        return None
    ms = [st["stages_ms"][n] for n in names if n in st["stages_ms"]]
    return sum(ms) / st[per] if ms else None


def idle_pct(rec: dict) -> float | None:
    p = rec.get("profile")
    if not p or not p["device_events"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def launches_per_mib(rec: dict, per: str) -> float | None:
    p = rec.get("profile")
    if not p or not p["launches"] or not p[per]:
        return None
    return p["launches"] / p[per]


def roofline_pct(rec: dict) -> float | None:
    """Percent of the device time of the kernel families that the cell's
    kind names (generator.Traffic.FAMILIES) that their least time fills;
    only families that ran count. None when none ran."""
    p = rec.get("profile")
    if not p:
        return None
    ran = [f for f, ms in p["family_ms"].items() if ms]
    if not ran:
        return None
    return (100.0 * sum(p["family_bound_ms"][f] for f in ran)
            / sum(p["family_ms"][f] for f in ran))
