"""A run's guards: it loads no module of JAX or of the JAX package, and it
prints no result without a card or without the program beside it."""
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parent.parent.parent
RUN = [sys.executable, "portbench/run.py", "--workload", "gzip6.compress-8m",
       "--seed", "3000000019", "--seconds", "1", "--trace", "0"]


def _env() -> dict:
    return dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    for name in ("zzflate_tpu_torch", "zzflate_tpu_torch.api", "jaxtyping",
                 "flaxen", "zzflate_tpux"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert [m for m in harness.forbidden_modules()
            if m.startswith(("zzflate", "jaxt", "flaxen"))] == []
    for name in ("zzflate_tpu.ops", "jax", "jaxlib.xla", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert {"zzflate_tpu.ops", "jax", "jaxlib.xla", "flax"} <= set(
        harness.forbidden_modules())


def test_cell_loads_no_jax_in_a_fresh_process():
    """A cell's set-up and calls at a small size on the CPU, in a fresh
    interpreter, leave no module of JAX or the JAX package loaded."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(ROOT)!r})
        from portbench import harness
        res = harness.run_cell(
            "gzip6.compress-8m", 3000000021, 0.0, False, device="cpu",
            overrides={{"traffic": {{"buffer_bytes": 30000, "pool": 1}},
                        "codec": {{"chunk_bytes": 4096}}}})
        print(json.dumps({{"correct": res["correct"],
                           "found": harness.forbidden_modules(),
                           "torch_port": "zzflate_tpu_torch" in sys.modules}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "found": [], "torch_port": True}


def test_no_card_no_result():
    out = subprocess.run(RUN, cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/ cannot run a
    cell: it exits non-zero and prints nothing on standard output."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(RUN, cwd=tmp_path, env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "No module named 'zzflate_tpu_torch'" in out.stderr


@pytest.mark.cuda
def test_run_on_the_card():
    """One short run of every cell on the card: exit 0, correct, and the
    result line's keys with the checks last."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cmd = RUN[:3] + [w["name"]] + RUN[4:]
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"], res["checks"]
        assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                                 "device"]
        assert list(res)[-1] == "checks"
        assert res["device"]["platform"] == "gpu"
