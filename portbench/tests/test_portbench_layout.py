"""BENCHMARK.json keeps the benchmark contract's shape, every cell's
configuration, traffic and metric files are found by name, and a new
configuration, traffic mix and metric join by adding files alone."""
import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness, trace

ROOT = Path(__file__).resolve().parent.parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
TINY = {"traffic": {"buffer_bytes": 20000, "pool": 1},
        "codec": {"chunk_bytes": 4096}}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    names = set()
    for kind, keys in KEYS.items():
        for e in SPEC[kind]:
            assert set(e) - {"workloads"} == keys, e["name"]
            assert NAME.match(e["name"]), e["name"]
            names.add((kind in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and kind != "end_to_end" and kind != "per_layer":
                    assert _line(e[k]), (e["name"], k)
            if "layer" in e:
                assert _line(e["layer"])
    assert len(names) == sum(len(SPEC[k]) for k in KEYS)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])


def test_every_cell_resolves_by_name():
    """Each cell's files load, and every metric a cell reports reads
    something: each per-layer metric's cells report the end-to-end metric
    it moves, and each cell reports setup_s, another end-to-end metric and
    a per-layer one."""
    for w in SPEC["workloads"]:
        cell = harness.resolve(w["name"], ROOT)
        assert callable(cell["kind"].control) and callable(cell["data"])
        assert set(cell["kind"].Traffic.FAMILIES) and callable(
            cell["format"].fault)
        assert set(cell["config"]["codec"]) == {
            "level", "format", "window_bits", "mem_level", "strategy",
            "chunk_bytes"}
        e2e = {m["name"] for m, _r in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell["per_layer"], w["name"]
        for m, read in cell["per_layer"]:
            assert m["moves"] in e2e, (w["name"], m["name"])
            assert callable(read)
    for c in SPEC["configs"]:
        assert c["file"].startswith("portbench/configs/")
        assert json.loads((ROOT / c["file"]).read_text())["source"] == (
            c["source"])


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


# A mix of a kind the benchmark lacks: Z_SYNC_FLUSH after every message,
# with a number of its own compared (each flush's output has to end on the
# empty stored block, 00 00 ff ff) and a kernel family of its own.
FLUSH_KIND = """
import contextlib
import zlib

from portbench import bounds, generator, trace


class Traffic(generator.EncodeTraffic):
    FAMILIES = dict(trace.ENCODE_FAMILIES, cast=("cast_kernel",))

    def reset(self):
        super().reset()
        self.unaligned = 0

    def run(self, j):
        from zzflate_tpu_torch import zlib_compat

        c = self.codec
        co = zlib_compat.compressobj(c["level"], zlib.DEFLATED,
                                     16 + c["window_bits"],
                                     device=self.device)
        buf, m = self.pool[j], int(self.mix["message_bytes"])
        parts = []
        for o in range(0, len(buf), m):
            parts.append(co.compress(buf[o:o + m]))
            parts.append(co.flush(zlib_compat.Z_SYNC_FLUSH))
            self.unaligned += not parts[-1].endswith(b"\\x00\\x00\\xff\\xff")
        parts.append(co.flush())
        return b"".join(parts)

    def check(self, failed):
        return dict(super().check(failed),
                    unaligned_flushes=(self.unaligned, 0))

    def bound_ms(self, i):
        n = len(self.pool[i % len(self.pool)])
        return dict(super().bound_ms(i),
                    cast=bounds.least_ms(n, 0)[0])


@contextlib.contextmanager
def control(fmt):
    yield
"""
REPEAT_DATA = """
import numpy as np


def make(nbytes, seed):
    unit = np.random.default_rng(seed).bytes(61)
    return (unit * (nbytes // 61 + 1))[:nbytes]
"""


def test_new_cell_joins_by_files_alone(tmp_path):
    """A copy of the benchmark takes a new configuration (gzip at level
    1), a traffic mix of a new kind (its own call, compared number and
    kernel family) on a new data source, and a new per-layer metric, as
    new files and BENCHMARK.json entries; no existing file of portbench/
    changes, a run of the new cell compares the kind's own number, and
    the new family counts in the cell's kernel roofline."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "portbench")
    spec = json.loads(json.dumps(SPEC))
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "gzip6.json").read_text())
    cfg.update(name="gzip1", source="zlib 1.2.13 zlib.h: Z_BEST_SPEED")
    cfg["codec"].update(level=1)
    (pb / "configs" / "gzip1.json").write_text(json.dumps(cfg))
    (pb / "kinds" / "flush.py").write_text(FLUSH_KIND)
    (pb / "data" / "repeat.py").write_text(REPEAT_DATA)
    (pb / "traffic" / "flush-4k.json").write_text(json.dumps(
        {"kind": "flush", "data": "repeat", "buffer_bytes": 20000,
         "message_bytes": 4096, "pool": 2}))
    (pb / "metrics" / "calls.count.py").write_text(
        "def read(rec):\n    return len(rec['calls'])\n")
    spec["configs"].append({"name": "gzip1", "source": cfg["source"],
                            "file": "portbench/configs/gzip1.json",
                            "reduced": [], "why": "the greedy path"})
    spec["workloads"].append({"name": "gzip1.flush-4k", "config": "gzip1",
                              "traffic": "flush-4k", "chips": 1,
                              "why": "a sync flush a message"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("encode_MBps", "size_ratio",
                         "kernels.encode_roofline"):
            m["workloads"].append("gzip1.flush-4k")
    spec["per_layer"].append({"name": "calls.count", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "facade and API",
                              "moves": "encode_MBps",
                              "workloads": ["gzip1.flush-4k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    assert _digests(pb).items() >= before.items()

    res = harness.run_cell("gzip1.flush-4k", 3, 0.1, False, root=tmp_path,
                           device="cpu")
    assert res["correct"], res["checks"]
    assert res["checks"]["unaligned_flushes"] == {"value": 0, "limit": 0}
    assert set(res["metrics"]) == {"encode_MBps", "size_ratio", "setup_s"}
    cell = harness.resolve("gzip1.flush-4k", tmp_path)
    assert [m["name"] for m, _r in cell["per_layer"]] == [
        "kernels.encode_roofline", "calls.count"]
    assert cell["per_layer"][1][1]({"calls": [1, 2]}) == 2

    # The kind's own family is read from the trace and counts in the
    # roofline that the cell reports: 1 ms of scan at a 0.5 ms bound and
    # 1 ms of the new kernel at a 0.25 ms bound fill 37.5%.
    traffic = harness.make_traffic(cell, 3, "cpu")
    events = [(trace.CALL, False, 1, 0.0, 5000.0),
              ("void scan_kernel<16>(int*)", True, 7, 100.0, 1100.0),
              ("cast_kernel", True, 7, 2000.0, 3000.0)]
    prof = trace.read_profile(events, [{"scan": 0.5, "propagate": 0.1,
                                        "parse": 0.1, "cast": 0.25}],
                              traffic.FAMILIES)
    read = dict((m["name"], r) for m, r in cell["per_layer"])[
        "kernels.encode_roofline"]
    assert read({"profile": prof}) == pytest.approx(37.5)
    with pytest.raises(RuntimeError, match="no bound"):
        trace.read_profile(events, [{"scan": 0.5}], traffic.FAMILIES)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_traced_run_reports_its_stage_metrics(workload):
    """On the CPU the trace has no device events, so only the stage
    metrics read; every one the cell lists that its stages feed is
    there."""
    ov = json.loads(json.dumps(TINY))
    if workload.endswith("decode-64m"):  # the CPU's plain decode is slow
        ov["traffic"].update(buffer_bytes=6000, check_sample=1)
    res = harness.run_cell(workload, 9, 0.0, True, root=ROOT, device="cpu",
                           overrides=ov)
    assert res["correct"]
    got = set(res["metrics"])
    want = {m["name"] for m, _r in harness.resolve(workload)["per_layer"]
            if m["source"] == "program_span"}
    assert got == want
    assert res["device"]["window_s"] > 0
    assert list(res)[-1] == "checks"
