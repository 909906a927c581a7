"""decode_scan.stream_split_pct's reader, on records and on traced runs of
the foreign gzip and zlib cells at a small size on the CPU: the share of
decode_scan that its nested stage decode_scan_stream_split (the byte-ranged
scan of one stream's blocks) covers."""
import os
from pathlib import Path

import pytest

from portbench import harness
from zzflate_tpu_torch import native

ROOT = Path(__file__).resolve().parent.parent.parent
CELLS = ["zlib-gzip6.decode-foreign-64m", "zlib1.decode-zlib-64m"]


def _read(rec):
    return harness.load_module(
        ROOT, "metrics", "decode_scan.stream_split_pct").read(rec)


@pytest.mark.parametrize("stages_ms,want", [
    ({"decode_scan": 40.0, "decode_scan_stream_split": 40.0}, 100.0),
    ({"decode_scan": 200.0, "decode_scan_stream_split": 50.0}, 25.0),
    ({"decode_scan": 200.0, "decode_scan_split": 190.0}, 0.0),
    ({"decode_plan": 70.0}, None),
])
def test_stream_split_pct_reads_the_share_of_the_scan(stages_ms, want):
    rec = {"stages": {"in_mib": 25.0, "out_mib": 64.0,
                      "stages_ms": stages_ms}}
    assert _read(rec) == want
    assert _read({}) is None  # an untraced run has no stages


def test_stream_split_pct_is_silent_without_a_byte_ranged_scan(monkeypatch):
    """A program with no byte-ranged scan (no native._scan_stream_ranges)
    reports nothing, not 0."""
    monkeypatch.delattr(native, "_scan_stream_ranges")
    assert _read({"stages": {"in_mib": 1.0, "out_mib": 1.0,
                             "stages_ms": {"decode_scan": 9.0}}}) is None


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_byte_ranged_scan(monkeypatch, cell):
    """One stream of ~100 KB split at 16 KiB a range on four cores: the
    traced run's line has the share, above 0."""
    monkeypatch.setattr(native, "SPLIT_MIN_BYTES", 1 << 14)
    monkeypatch.setattr(os, "sched_getaffinity", lambda _pid: set(range(4)))
    res = harness.run_cell(cell, 2**31 + 27, 0.0, True, root=ROOT,
                           device="cpu",
                           overrides={"traffic": {"buffer_bytes": 250000,
                                                  "pool": 1,
                                                  "check_sample": 1}})
    assert res["correct"], res["checks"]
    assert 0 < res["metrics"]["decode_scan.stream_split_pct"]["value"] <= 100
