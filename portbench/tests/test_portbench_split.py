"""decode_scan.split_pct's reader, on records and on a traced run of the
BGZF cell at a small size on the CPU: the share of decode_scan that its
nested stage decode_scan_split (the ranged scan of BGZF members) covers."""
import os
from pathlib import Path

import pytest

from portbench import harness
from zzflate_tpu_torch import native

ROOT = Path(__file__).resolve().parent.parent.parent
BGZF = "bgzf6.decode-bgzf-64m"


def _read(rec):
    return harness.load_module(ROOT, "metrics", "decode_scan.split_pct").read(
        rec)


@pytest.mark.parametrize("stages_ms,want", [
    ({"decode_scan": 240.0, "decode_scan_split": 240.0}, 100.0),
    ({"decode_scan": 200.0, "decode_scan_split": 50.0}, 25.0),
    ({"decode_scan": 240.0, "decode_plan": 70.0}, 0.0),
    ({"decode_plan": 70.0}, None),
])
def test_split_pct_reads_the_share_of_the_scan(stages_ms, want):
    rec = {"stages": {"in_mib": 25.0, "out_mib": 64.0,
                      "stages_ms": stages_ms}}
    assert _read(rec) == want
    assert _read({}) is None  # an untraced run has no stages


def test_split_pct_is_silent_without_a_ranged_scan(monkeypatch):
    """A program with no ranged scan (no native.bgzf_starts) reports
    nothing, not 0."""
    monkeypatch.delattr(native, "bgzf_starts")
    assert _read({"stages": {"in_mib": 1.0, "out_mib": 1.0,
                             "stages_ms": {"decode_scan": 9.0}}}) is None


def test_traced_bgzf_run_reads_the_ranged_scan(monkeypatch):
    """Three data members a file, split with a range a member on four
    cores: the traced run's line has the share, above 0."""
    monkeypatch.setattr(native, "SPLIT_MIN_MEMBERS", 1)
    monkeypatch.setattr(os, "sched_getaffinity", lambda _pid: set(range(4)))
    res = harness.run_cell(BGZF, 2**31 + 7, 0.0, True, root=ROOT,
                           device="cpu",
                           overrides={"traffic": {"buffer_bytes": 150000,
                                                  "pool": 1,
                                                  "check_sample": 1}})
    assert res["correct"], res["checks"]
    assert 0 < res["metrics"]["decode_scan.split_pct"]["value"] <= 100
