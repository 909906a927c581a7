"""The matcher's three hand-written CUDA kernels, their plain torch versions,
the nvcc/ctypes loader and the launch counters.

Each wrapper takes the JAX package's layout with a batch dimension:
(B, n) int32 tensors, one row per chunk. A CPU tensor goes to the plain
torch version in this module (the CPU path and the test oracle); a CUDA
tensor goes to the kernel, or the wrapper raises. There is no fallback
from one to the other.

The sources live in ``zzflate_tpu_torch/csrc``. At first use on a CUDA
tensor they are compiled with nvcc (one process per source, all started
together, then one link) into ``zzflate_tpu_torch/_build/`` under a name
keyed on a hash of the sources and flags, and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from zzflate_tpu_torch.constants import MAX_MATCH, WINDOW_SIZE

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_SOURCES = ("scan.cu", "propagate.cu", "parse.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Kernel launches per wrapper, counted where the kernel is launched and
# nowhere else (plain-version calls do not count).
launches = {"scan_candidates": 0, "propagate_matches": 0, "parse_rows": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Build and load.
# ---------------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()
build_log = ""  # ptxas resource report of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in ("kernels.h",) + _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels into _build/ (a no-op when the hash matches)."""
    global build_log
    _BUILD.mkdir(exist_ok=True)
    target = _BUILD / f"libzzflate_kernels_{_source_key()}.so"
    if target.exists():
        return target
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        procs = []
        for name in _SOURCES:
            obj = Path(tmp) / (name + ".o")
            procs.append((name, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c",
                 str(_CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        logs = []
        failed = []
        for name, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {name}\n{out}")
            if p.returncode != 0:
                failed.append(name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n{build_log}"
            )
        tmp_so = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_so), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, target)
    return target


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.zz_scan_candidates.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
            lib.zz_propagate_matches.argtypes = [p, p, i, i, p]
            lib.zz_parse_rows.argtypes = [p, p, p, p, p, i, i, i, p]
            for fn in (lib.zz_scan_candidates, lib.zz_propagate_matches,
                       lib.zz_parse_rows):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _route(*ts: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain version."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def _raise_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name}: CUDA launch failed with cudaError {rc}"
        )


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# 1. scan_candidates
# ---------------------------------------------------------------------------


def scan_candidates(adj, spos, window_start, k_each: int, lcp_cap: int,
                    backward_only: bool = False):
    """K-neighbour candidate scan over a sorted suffix order.

    adj, spos: (B, n) int32 (adjacent LCPs and positions in sort order);
    window_start: (B,) int32. Returns (s_len, s_dist), (B, n) int32.
    """
    for nm, t, d in (("adj", adj, 2), ("spos", spos, 2),
                     ("window_start", window_start, 1)):
        _check(nm, t, d)
    if spos.shape != adj.shape or window_start.shape != adj.shape[:1]:
        raise ValueError("scan_candidates: shape mismatch")
    if not 1 <= k_each <= 64:
        raise ValueError("scan_candidates: k_each must be in 1..64")
    if not _route(adj, spos, window_start):
        return scan_candidates_plain(adj, spos, window_start, k_each,
                                     lcp_cap, backward_only)
    b, n = adj.shape
    out_len = torch.empty_like(adj)
    out_dist = torch.empty_like(adj)
    if b and n:
        with torch.cuda.device(adj.device):
            rc = _load().zz_scan_candidates(
                adj.data_ptr(), spos.data_ptr(), window_start.data_ptr(),
                out_len.data_ptr(), out_dist.data_ptr(), b, n, k_each,
                lcp_cap, int(backward_only), _stream(adj),
            )
        _raise_rc("scan_candidates", rc)
        launches["scan_candidates"] += 1
    return out_len, out_dist


def scan_candidates_plain(adj, spos, window_start, k_each: int,
                          lcp_cap: int, backward_only: bool = False):
    """Plain torch version: the reference's roll loop (matcher.py:166-207)
    with a batch dimension; neighbours outside the row are rejected."""
    b, n = adj.shape
    srank = torch.arange(n, device=adj.device)[None, :]
    ws = window_start[:, None]
    s_len = torch.zeros_like(adj)
    s_dist = torch.zeros_like(adj)

    def consider(s_len, s_dist, ln_ok, dist, ok):
        ln = torch.where(ok, ln_ok, 0)
        better = (ln > s_len) | ((ln == s_len) & (ln > 0) & (dist < s_dist))
        better = better & ok
        return torch.where(better, ln, s_len), torch.where(better, dist, s_dist)

    back_min = torch.full_like(adj, lcp_cap)
    fwd_min = torch.full_like(adj, lcp_cap)
    for k in range(1, k_each + 1):
        back_min = torch.minimum(back_min, torch.roll(adj, k - 1, 1))
        cpos = torch.roll(spos, k, 1)
        dist = spos - cpos
        ok = ((srank >= k) & (dist >= 1) & (dist <= WINDOW_SIZE)
              & (cpos >= ws))
        s_len, s_dist = consider(s_len, s_dist, back_min, dist, ok)
        if backward_only:
            continue
        fwd_min = torch.minimum(fwd_min, torch.roll(adj, -k, 1))
        cpos = torch.roll(spos, -k, 1)
        dist = spos - cpos
        ok = ((srank < n - k) & (dist >= 1) & (dist <= WINDOW_SIZE)
              & (cpos >= ws))
        s_len, s_dist = consider(s_len, s_dist, fwd_min, dist, ok)
    return s_len, s_dist


# ---------------------------------------------------------------------------
# 2. propagate_matches
# ---------------------------------------------------------------------------


def propagate_matches(pk):
    """Interior-suffix propagation of the packed best array.

    pk: (B, n) int32, len << 15 | (32768 - dist), 0 where no match.
    Returns (B, n) int32 after nine doubling rounds (shifts 1..256)."""
    _check("pk", pk, 2)
    if not _route(pk):
        return propagate_matches_plain(pk)
    b, n = pk.shape
    out = torch.empty_like(pk)
    if b and n:
        with torch.cuda.device(pk.device):
            rc = _load().zz_propagate_matches(
                pk.data_ptr(), out.data_ptr(), b, n, _stream(pk)
            )
        _raise_rc("propagate_matches", rc)
        launches["propagate_matches"] += 1
    return out


def propagate_matches_plain(pk):
    """Plain torch version: the reference's doubling loop
    (matcher.py:419-426) with a batch dimension."""
    pos = torch.arange(pk.shape[1], device=pk.device)[None, :]
    shift = 1
    while shift < MAX_MATCH:
        cand = torch.roll(pk, shift, 1) - (shift << 15)
        cand = torch.where((pos >= shift) & (cand >= (3 << 15)), cand, 0)
        pk = torch.maximum(pk, cand)
        shift *= 2
    return pk


# ---------------------------------------------------------------------------
# 3. parse_rows
# ---------------------------------------------------------------------------

_SINK = 1 << 30
_MAX_ROW = 768  # P1 keeps row x 32 u16 exit offsets in 48 KB of shared memory


def parse_rows(step, starts, row: int):
    """Commit marks of the serial walk next[p] = p + step[p] per chunk.

    step: (B, npad) int32 with every step in [1, 258] and npad % row == 0;
    starts: (B,) int32. Returns mark (B, npad) int32 (1 = committed)."""
    _check("step", step, 2)
    _check("starts", starts, 1)
    b, npad = step.shape
    if starts.shape != (b,):
        raise ValueError("parse_rows: starts must be (B,)")
    if not MAX_MATCH < row <= _MAX_ROW or npad % row:
        raise ValueError(
            f"parse_rows: need 258 < row <= {_MAX_ROW} and npad % row == 0"
        )
    if not _route(step, starts):
        return parse_rows_plain(step, starts, row)
    mark = torch.empty_like(step)
    if b and npad:
        exits = torch.empty_like(step)
        entries = torch.empty((b, npad // row), dtype=torch.int32,
                              device=step.device)
        with torch.cuda.device(step.device):
            rc = _load().zz_parse_rows(
                step.data_ptr(), starts.data_ptr(), exits.data_ptr(),
                entries.data_ptr(), mark.data_ptr(), b, npad, row,
                _stream(step),
            )
        _raise_rc("parse_rows", rc)
        launches["parse_rows"] += 1
    return mark


def parse_rows_plain(step, starts, row: int):
    """Plain torch version: the reference's P1/P2/P3 sweeps
    (matcher.py:538-614) with chunk-local exits, as the TPU kernel keeps
    them."""
    b, npad = step.shape
    dev = step.device
    rows_per = npad // row
    lanes = b * rows_per
    st = step.reshape(lanes, row)
    lane_base = (torch.arange(lanes, device=dev) % rows_per) * row

    # P1: reverse exit sweep, all rows as parallel lanes.
    ex = torch.zeros((lanes, row), dtype=torch.int32, device=dev)
    for j in range(row - 1, -1, -1):
        land = j + st[:, j]
        hop = ex.gather(1, land.clamp(0, row - 1)[:, None].long())[:, 0]
        ex[:, j] = torch.where(land >= row, lane_base + land, hop).int()

    # P2: chain row entries per chunk.
    ex3 = ex.reshape(b, rows_per, row)
    bidx = torch.arange(b, device=dev)
    r0 = torch.div(starts, row, rounding_mode="floor")
    entries = torch.full((b, rows_per), _SINK, dtype=torch.int32, device=dev)
    e = torch.zeros_like(starts)
    for r in range(rows_per):
        e = torch.where(r0 == r, starts, e)
        live = r >= r0
        cur = torch.where(live, e, _SINK)
        entries[:, r] = cur
        j = (cur - r * row).clamp(0, row - 1).long()
        e = torch.where(live, ex3[bidx, r, j], e)

    # P3: forward mark walk of every row from its entry.
    ent = entries.reshape(lanes)
    j = ent - lane_base
    active = (ent < _SINK) & (j >= 0) & (j < row)
    mark = torch.zeros((lanes, row), dtype=torch.int32, device=dev)
    for _ in range(row):
        jc = j.clamp(0, row - 1).long()[:, None]
        mark.scatter_reduce_(1, jc, active.int()[:, None], "amax")
        s = st.gather(1, jc)[:, 0]
        j = torch.where(active, j + s, j)
        active = active & (j < row)
    return mark.reshape(b, npad)
