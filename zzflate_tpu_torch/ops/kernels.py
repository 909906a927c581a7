"""The port's hand-written CUDA kernels, their plain torch versions, the
nvcc/ctypes loader and the launch counters: the matcher's three
(scan_candidates, propagate_matches, parse_rows), device decode's
anchor walk, candidate decode, commit walk and token scatter (the last
three on the per-bit path of indexes without anchors) and LZ resolve
(both paths), and the checksums over row ranges (crc32_rows,
adler32_rows) that device decode's group CRC and the encode's per-chunk
partials run on.

The matcher's wrappers take the JAX package's layout with a batch
dimension: (B, n) int32 tensors, one row per chunk. A CPU tensor goes to the plain
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
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import zlib
from pathlib import Path

import numpy as np
import torch

from zzflate_tpu_torch.constants import MAX_MATCH, WINDOW_SIZE
from zzflate_tpu_torch.ops.canonical import (
    _M32,
    _MAX_D,
    _MAX_LL,
    _bit_windows,
    _build_luts,
    _canon_lane_tables,
    _decode_bits,
    _decode_bits_canon,
    _on_device,
)
from zzflate_tpu_torch.ops.checksum_math import (
    ADLER_MOD,
    CRC_TABLE,
    byte_tables,
)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_SOURCES = ("scan.cu", "propagate.cu", "parse.cu", "walk.cu", "checksum.cu",
            "commit.cu", "resolve.cu", "candidates.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Kernel launches per wrapper, counted where the kernel is launched and
# nowhere else (plain-version calls do not count).
launches = {"scan_candidates": 0, "propagate_matches": 0, "parse_rows": 0,
            "anchor_walk": 0, "crc32_rows": 0, "adler32_rows": 0,
            "commit_walk": 0, "token_scatter": 0, "resolve_lz": 0,
            "decode_candidates": 0}


# The walk's launch shape, as csrc/kernels.h defines it (a test holds the
# two equal): one warp of WALK_THREADS lanes a block, holding the primary
# decode tables of at most WALK_UNITS units (2^WALK_LL_BITS litlen and
# 2^WALK_D_BITS distance entries each) in WALK_SMEM_BYTES of shared memory.
WALK_THREADS = 32
WALK_UNITS = 4
WALK_LL_BITS = 10
WALK_D_BITS = 8
WALK_SMEM_BYTES = (WALK_UNITS * ((1 << WALK_LL_BITS) + (1 << WALK_D_BITS))
                   + 48 + _MAX_LL) * 4


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
            lib.zz_parse_exits.argtypes = [p, p, p, p, i, i, i, p]
            lib.zz_parse_marks.argtypes = [p, p, p, p, p, i, i, i, p]
            lib.zz_anchor_walk.argtypes = [p, i, p, p, p, p, p, p, p, p, i,
                                           p, p, p, p, i, p, i, i, p]
            lib.zz_crc32_rows.argtypes = [p, i, i, p, p, i, i, p, p, i, p, p]
            lib.zz_adler32_rows.argtypes = [p, i, i, p, p, i, i, p, i, p, p]
            lib.zz_commit_walk.argtypes = [p, i, p, p, i, i, p, p, p, p, p]
            lib.zz_token_scatter.argtypes = [p, p, p, p, p, p, i, p, p, p, i,
                                             p]
            lib.zz_resolve_lz.argtypes = [p, p, p, i, p, p, p, p, p, p, p]
            lib.zz_decode_candidates.argtypes = [p, i] + [p] * 12 + [i] + (
                [p] * 9)
            for fn in (lib.zz_scan_candidates, lib.zz_propagate_matches,
                       lib.zz_parse_exits, lib.zz_parse_marks,
                       lib.zz_anchor_walk, lib.zz_crc32_rows,
                       lib.zz_adler32_rows, lib.zz_commit_walk,
                       lib.zz_token_scatter, lib.zz_resolve_lz,
                       lib.zz_decode_candidates):
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

    adj, spos: (B, n) int32 (adjacent LCPs and positions in sort order;
    the kernel is exact for positions in [0, 2^30), which a suffix order
    of n < 2^30 positions gives); window_start: (B,) int32. Returns
    (s_len, s_dist), (B, n) int32. The kernel packs len << 15 into one
    key, so lcp_cap must be below 2^15.
    """
    for nm, t, d in (("adj", adj, 2), ("spos", spos, 2),
                     ("window_start", window_start, 1)):
        _check(nm, t, d)
    if spos.shape != adj.shape or window_start.shape != adj.shape[:1]:
        raise ValueError("scan_candidates: shape mismatch")
    if not 1 <= k_each <= 64:
        raise ValueError("scan_candidates: k_each must be in 1..64")
    if not 0 <= lcp_cap < 1 << 15:
        raise ValueError("scan_candidates: lcp_cap must be in [0, 2^15)")
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

    pk: (B, n) int32, len << 15 | (32768 - dist), 0 where no match: every
    entry in [0, 2^31), which is what the matcher hands in. Returns (B, n)
    int32 after nine doubling rounds (shifts 1..256). The CUDA kernel is
    not defined for a negative entry, which the plain version maps to 0."""
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
# The marks kernel stages 32 rows of u16 steps and part landings, and the
# part entries, in 128 * (row + 2) + 1024 bytes of shared memory: 66.8 KB
# at row 512, 132 KB at 1024 (a block may have 227 KB).
_MAX_ROW = 1024


def parse_rows(step, starts, row: int):
    """Commit marks of the serial walk next[p] = p + step[p] per chunk.

    step: (B, npad) int32 with every step in [1, 258] and npad % row == 0;
    starts: (B,) int32. Returns mark (B, npad) int32 (1 = committed)."""
    _check("step", step, 2)
    _check("starts", starts, 1)
    b, npad = step.shape
    if starts.shape != (b,):
        raise ValueError("parse_rows: starts must be (B,)")
    if not MAX_MATCH < row <= _MAX_ROW or row % 128 or npad % row:
        raise ValueError(
            f"parse_rows: need 258 < row <= {_MAX_ROW}, row % 128 == 0 "
            "and npad % row == 0"
        )
    if not _route(step, starts):
        return parse_rows_plain(step, starts, row)
    mark, phases = parse_rows_phases(step, starts, row)
    if phases:
        with torch.cuda.device(step.device):
            for name, launch in phases:
                _raise_rc(f"parse_rows ({name})", launch())
        launches["parse_rows"] += 1
    return mark


def parse_rows_phases(step, starts, row: int):
    """The output and the kernel launches of one parse_rows call on the
    card, as (name, launch) pairs to be run in turn: 'exits' (exits and
    prefix tables), 'marks' (segment chain and marks); each launch returns
    the CUDA error code. Takes what parse_rows has checked; chip_smoke.py
    times each phase."""
    b, npad = step.shape
    mark = torch.empty_like(step)
    if not (b and npad):
        return mark, []
    if step.data_ptr() % 16:
        raise ValueError("parse_rows: step must be 16-byte aligned")
    dev = step.device
    # u16 prefix tables, 258 a row; the start segment's 32 row entries and
    # the next segment's entry.
    pre = torch.empty((b, npad // row, MAX_MATCH), dtype=torch.int16,
                      device=dev)
    seg0_ent = torch.empty((b, 33), dtype=torch.int32, device=dev)
    lib = _load()
    s = _stream(step)
    # The launches hold the tensors, so the scratch outlives them.
    return mark, [
        ("exits", lambda: lib.zz_parse_exits(
            step.data_ptr(), starts.data_ptr(), pre.data_ptr(),
            seg0_ent.data_ptr(), b, npad, row, s)),
        ("marks", lambda: lib.zz_parse_marks(
            step.data_ptr(), starts.data_ptr(), pre.data_ptr(),
            seg0_ent.data_ptr(), mark.data_ptr(), b, npad, row, s)),
    ]


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


# ---------------------------------------------------------------------------
# 4. anchor_walk (device decode)
# ---------------------------------------------------------------------------

def anchor_walk(words, ll, d, lanes, packed, t_steps: int):
    """Token walk of device decode: every lane decodes up to t_steps
    tokens serially and max-combines each token's
    dist << 9 | lit << 1 | 1 into packed[o] (o >= len(packed) is
    dropped). packed is updated in place and returned.

    words: (nw,) int32, the group's body as u32 bits, nw >= 3;
    ll, d: (hi_mono, fsh, off, sym) per unit: (U, 16) int32 x 3 and
    (U, 288) or (U, 32) int32 (ops/canonical._canon_unit_tables), the
    symbols in [0, 288) and [0, 32);
    lanes: (bit, out, uid, valid), (L,) int32 each, bit and out >= 0;
    packed: (n_out_pad,) int32, every entry >= 0.

    Any lane order gives the same packed. The kernel decodes fastest when
    every run of WALK_THREADS lanes spans at most WALK_UNITS units from
    its lowest (models/inflate_device._walk_lanes plans them so); other
    lanes decode every window by the compare ladder."""
    lane_bit, lane_out, lane_uid, lane_valid = lanes
    ts = [("words", words, 1), ("packed", packed, 1)]
    ts += [(f"ll[{k}]", t, 2) for k, t in enumerate(ll)]
    ts += [(f"d[{k}]", t, 2) for k, t in enumerate(d)]
    ts += [(f"lanes[{k}]", t, 1) for k, t in enumerate(lanes)]
    for nm, t, nd in ts:
        _check(nm, t, nd)
    u = ll[0].shape[0]
    if (words.shape[0] < 3 or u < 1
            or any(t.shape != (u, 16) for t in ll[:3] + d[:3])
            or ll[3].shape != (u, _MAX_LL) or d[3].shape != (u, _MAX_D)
            or any(t.shape != lane_bit.shape for t in lanes)):
        raise ValueError("anchor_walk: shape mismatch")
    if not _route(words, packed, *ll, *d, *lanes):
        return anchor_walk_plain(words, ll, d, lanes, packed, t_steps)
    n_lanes = lane_bit.shape[0]
    if n_lanes and t_steps > 0 and packed.shape[0]:
        with torch.cuda.device(words.device):
            rc = _load().zz_anchor_walk(
                words.data_ptr(), words.shape[0],
                *(t.data_ptr() for t in ll), *(t.data_ptr() for t in d), u,
                *(t.data_ptr() for t in lanes), n_lanes,
                packed.data_ptr(), packed.shape[0], t_steps,
                _stream(words),
            )
        _raise_rc("anchor_walk", rc)
        launches["anchor_walk"] += 1
    return packed


def anchor_walk_plain(words, ll, d, lanes, packed, t_steps: int):
    """Plain torch version: the reference's deferred walk loop
    (inflate_tpu.py:777-845): t_steps lane-wide steps that keep the
    three-word cache and record (target, packed value) rows, then one
    scatter-max over all records. u32 arithmetic in int64, masked."""
    lane_bit, lane_out, lane_uid, lane_valid = lanes
    dev = words.device
    n_out_pad = packed.shape[0]
    nw = words.shape[0]
    n_lanes = lane_bit.shape[0]
    uid = lane_uid.long().clamp(0, ll[0].shape[0] - 1)
    llt = _canon_lane_tables(ll[:3], uid)
    dt = _canon_lane_tables(d[:3], uid)
    ll_sym_flat = ll[3].long().reshape(-1)
    d_sym_flat = d[3].long().reshape(-1)
    w = words.long() & _M32
    valid = lane_valid != 0
    p = torch.where(valid, lane_bit.long(), 0)
    o = torch.where(valid, lane_out.long(), n_out_pad)
    active = valid
    wi_prev = (p >> 5).clamp(0, nw - 3)
    c0, c1, c2 = w[wi_prev], w[wi_prev + 1], w[wi_prev + 2]
    rec_tgt = torch.full((t_steps, n_lanes), n_out_pad, dtype=torch.long,
                         device=dev)
    rec_pack = torch.zeros((t_steps, n_lanes), dtype=torch.long, device=dev)
    for t in range(t_steps):
        # A token is <= 48 bits, so the window's base word advances by at
        # most 2 a step: the first word comes from the carried cache.
        wi = (p >> 5).clamp(0, nw - 3)
        s = p & 31
        delta = wi - wi_prev
        w0 = torch.where(delta == 0, c0, torch.where(delta == 1, c1, c2))
        w1 = w[wi + 1]
        w2 = w[wi + 2]
        inv = 31 - s
        lo = (w0 >> s) | ((((w1 << inv) & _M32) << 1) & _M32)
        hi = (w1 >> s) | ((((w2 << inv) & _M32) << 1) & _M32)
        stepw, outlen, sym, mdist, islit, islen, _eob = (
            _decode_bits_canon(lo, hi, uid, llt, dt, ll_sym_flat,
                                   d_sym_flat)
        )
        emit = active & (islit | islen)
        tgt = torch.where(emit, o, n_out_pad)
        lit = torch.where(islit, sym, 0)
        dst = torch.where(islen, mdist, 0)
        o = o + torch.where(emit, outlen, 0)
        ok = stepw <= 48  # EOB/invalid decode as _HUGE: the lane is done
        p = p + torch.where(active & ok, stepw, 0)
        active = active & ok
        c0, c1, c2, wi_prev = w0, w1, w2, wi
        rec_tgt[t] = tgt
        rec_pack[t] = torch.where(tgt < n_out_pad,
                                  (dst << 9) | (lit << 1) | 1, 0)
        # On the CPU, end the loop once every lane has stopped: the rows
        # left would hold only dropped targets. On a card the check would
        # sync the host, so the loop there runs all t_steps as the
        # reference's does.
        if dev.type == "cpu" and t % 32 == 31 and not bool(active.any()):
            break
    # .at[rec_tgt].max(rec_pack, mode="drop"): out-of-range targets land
    # in a trash slot past the end.
    idx = rec_tgt.reshape(-1)
    idx = torch.where((idx >= 0) & (idx < n_out_pad), idx, n_out_pad)
    buf = torch.cat([packed.long(), packed.new_zeros(1).long()])
    buf.scatter_reduce_(0, idx, rec_pack.reshape(-1), "amax")
    packed.copy_(buf[:n_out_pad])
    return packed


# ---------------------------------------------------------------------------
# 5. crc32_rows and adler32_rows (device decode's group CRC, the encode's
#    per-chunk partials)
# ---------------------------------------------------------------------------

# The checksum kernels' launch shape, as csrc/kernels.h defines it (a test
# holds the two equal): a thread takes CKS_SEG bytes of a row's range, a
# block CKS_THREADS threads, so one block covers CKS_BLOCK_BYTES.
CKS_SEG = 64
CKS_THREADS = 256
CKS_BLOCK_BYTES = CKS_SEG * CKS_THREADS
# A^(2^j) byte tables the CRC kernel reads: j < 32 covers every shift of a
# row below 2^31 bytes.
CKS_POW_LEVELS = 32
ADLER_BLOCK = 1024  # level-0 block of the plain Adler tree: small partials


def crc32_rows(data, ends, starts):
    """CRC-32 (zlib/gzip polynomial) of data[b, starts[b]:ends[b]] for
    every row b of a (B, N) uint8 tensor, N < 2^31 and 0 <= start <= end
    <= N. ends and starts are (B,) integer tensors (or arrays), or two
    ints that every row shares. Returns (B,) int64 holding u32 values on
    the data's device; an empty range gives 0."""
    return _checksum_rows("crc32_rows", data, ends, starts)


def adler32_rows(data, ends, starts):
    """Adler-32 of data[b, starts[b]:ends[b]] for every row b, as
    crc32_rows takes them. Returns (B,) int64 holding u32 values on the
    data's device; an empty range gives 1."""
    return _checksum_rows("adler32_rows", data, ends, starts)


def _checksum_rows(name: str, data, ends, starts):
    if data.dtype != torch.uint8:
        raise TypeError(f"{name}: expected uint8, got {data.dtype}")
    if data.dim() != 2:
        raise ValueError(
            f"{name}: expected 2-D, got shape {tuple(data.shape)}")
    if not data.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    b, n = data.shape
    shared = isinstance(ends, int) and isinstance(starts, int)
    if shared:
        if not 0 <= starts <= ends <= n:
            raise ValueError(f"{name}: need 0 <= start <= end <= N")
    else:
        ends = torch.as_tensor(ends, device=data.device)
        starts = torch.as_tensor(starts, device=data.device)
        if ends.shape != (b,) or starts.shape != (b,):
            raise ValueError(f"{name}: ends and starts must be (B,)")
    plain = crc32_rows_plain if name == "crc32_rows" else adler32_rows_plain
    if not _route(data):
        return plain(data, ends, starts)
    if n >= 1 << 31:
        raise ValueError(f"{name}: rows must be shorter than 2^31 bytes")
    dev = data.device
    out = torch.empty((b,), dtype=torch.int64, device=dev)
    if not b:
        return out
    if shared:
        # One range for every row: the grid covers just that range.
        span, bounds = ends - starts, (None, None, ends, starts)
    else:
        ends = ends.to(torch.int32).contiguous()
        starts = starts.to(torch.int32).contiguous()
        span, bounds = n, (ends.data_ptr(), starts.data_ptr(), 0, 0)
    nblk = max(1, -(-span // CKS_BLOCK_BYTES))
    part = torch.empty((b * nblk * 2,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        lib = _load()
        if name == "crc32_rows":
            rc = lib.zz_crc32_rows(
                data.data_ptr(), b, n, *bounds, _cks_tables_on(dev).data_ptr(),
                part.data_ptr(), nblk, out.data_ptr(), _stream(data))
        else:
            rc = lib.zz_adler32_rows(
                data.data_ptr(), b, n, *bounds, part.data_ptr(), nblk,
                out.data_ptr(), _stream(data))
    _raise_rc(name, rc)
    launches[name] += 1
    return out


@functools.cache
def _cks_tables_on(device: torch.device) -> torch.Tensor:
    """The CRC kernel's tables, uploaded once per card: T (256 u32), then
    the four byte tables of A^(2^j) for j < CKS_POW_LEVELS (1 024 u32
    each), as int32 bits."""
    tabs = np.concatenate([CRC_TABLE.astype(np.int64)]
                          + [byte_tables(j).reshape(-1)
                             for j in range(CKS_POW_LEVELS)])
    return torch.from_numpy(tabs.astype(np.uint32).view(np.int32)).to(device)


def _gf_matvec_batch(tables: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply a GF(2) 32x32 matrix to a batch of u32 (int64) values.

    The reference XORs the 32 columns selected by v's bits (128
    elementwise steps); the map is linear, so it equals the XOR of its
    images of v's four bytes, looked up in the matrix's (4, 256) byte
    tables (``checksum_math.byte_tables``): 4 gathers."""
    out = tables[0][v & 0xFF]
    for k in range(1, 4):
        out = out ^ tables[k][(v >> (8 * k)) & 0xFF]
    return out


@functools.cache
def _tables_on(j: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(byte_tables(j)).to(device)


@functools.cache
def _crc_table_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(CRC_TABLE.astype(np.int64)).to(device)


def _crc_tree(c: torch.Tensor) -> torch.Tensor:
    """Tree-combine per-byte CRC contributions along the last axis:
    c(L||R) = A^len(R) c(L) ^ c(R), with len(R) = 2^j at level j. An odd
    level prepends an all-zero segment on the left, where leading zeros
    are transparent to the zero-init contribution, so the result is the
    contribution of the whole width for any width."""
    dev = c.device
    level = 0
    while c.shape[-1] > 1:
        if c.shape[-1] % 2:
            c = torch.cat([c.new_zeros(c.shape[:-1] + (1,)), c], dim=-1)
        c = (_gf_matvec_batch(_tables_on(level, dev), c[..., 0::2])
             ^ c[..., 1::2])
        level += 1
    return c[..., 0]


def _row_window(data: torch.Tensor, ends, starts):
    """(B, N) uint8 and per-row [start, end) -> int64 bytes with the rest
    zeroed, and the bounds as (B,) int64 on the data's device."""
    dev = data.device
    ends = torch.as_tensor(ends, device=dev).long().expand(data.shape[:1])
    starts = torch.as_tensor(starts, device=dev).long().expand(data.shape[:1])
    idx = torch.arange(data.shape[1], device=dev)[None, :]
    keep = (idx >= starts[:, None]) & (idx < ends[:, None])
    return torch.where(keep, data.long(), 0), ends, starts


@functools.cache
def _short_init_on(device: torch.device) -> torch.Tensor:
    """(5,) int64: for a range of L < 4 bytes, what its init fold
    A^L(0xFFFFFFFF) differs by from the zero-init contribution of 0xFF
    in its first L bytes (crc32(b"\\xff" * L) ^ 0xFFFFFFFF); 0 for L >= 4,
    where the two are equal."""
    vals = [zlib.crc32(b"\xff" * k) ^ _M32 for k in range(4)] + [0]
    return torch.tensor(vals, dtype=torch.int64, device=device)


def crc32_rows_plain(data, ends, starts):
    """Plain torch version of crc32_rows: the reference's _crc32_impl tree
    under vmap, with each row shifted so its range ends at the last
    column. The tree's zero padding is then all on the left, where it is
    transparent, so no row needs the reference's per-bit right-padding
    correction. The init 0xFFFFFFFF contributes A^len(0xFFFFFFFF), which
    equals 0xFF XORed into the range's first 4 bytes (for len >= 4;
    shorter ranges take a constant from a table): no per-bit init fold
    either."""
    bch, n = data.shape
    if n == 0:
        data = data.new_zeros((bch, 1))
        n = 1
    x, ends, starts = _row_window(data, ends, starts)
    idx = torch.arange(n, device=x.device)[None, :]
    head = torch.minimum(starts + 4, ends)[:, None]
    x = torch.where((idx >= starts[:, None]) & (idx < head), x ^ 0xFF, x)
    src = idx - (n - ends)[:, None]
    x = torch.where(src >= 0, x.gather(1, src.clamp(min=0)), 0)
    c = _crc_tree(_crc_table_on(x.device)[x])
    short = _short_init_on(x.device)[(ends - starts).clamp(max=4)]
    return c ^ short ^ _M32


def _adler_tree(x: torch.Tensor, block: int):
    """S/W partials of (..., n_pad) int64 bytes, n_pad a multiple of
    block, tree-combined along the last axis. At each level pairs of
    equal-length segments merge; odd levels append an implicit all-zero
    segment, so the effective padded length `seg` grows past n_pad and
    the caller's right-padding correction uses it. Returns (S, W_pad,
    seg), S and W mod 65521."""
    m = ADLER_MOD
    x = x.reshape(x.shape[:-1] + (x.shape[-1] // block, block))
    weights = block - torch.arange(block, device=x.device)
    s = x.sum(-1) % m
    w = (x * weights).sum(-1) % m
    seg = block
    while s.shape[-1] > 1:
        if s.shape[-1] % 2:
            zero = s.new_zeros(s.shape[:-1] + (1,))
            s = torch.cat([s, zero], dim=-1)
            w = torch.cat([w, zero], dim=-1)
        sl, sr = s[..., 0::2], s[..., 1::2]
        wl, wr = w[..., 0::2], w[..., 1::2]
        w = (wl + (((seg % m) * sl) % m) + wr) % m
        s = (sl + sr) % m
        seg *= 2
    return s[..., 0], w[..., 0], seg


def _adler_finish(s_total, w_pad, seg: int, length, start):
    """Adler-32 from the tree's partials: right-padding correction
    (padded zero bytes inflate every weight by seg - length, so W_true =
    W_pad - pad*S mod m) and the n term. length and start are (B,) int64
    tensors."""
    m = ADLER_MOD
    pad = ((seg - length) & _M32) % m
    w_true = (w_pad + ((m - pad) % m) * s_total % m) % m
    n_mod = ((length - start) & _M32) % m
    s1 = (1 + s_total) % m
    s2 = (n_mod + w_true) % m
    return (s2 << 16) | s1


def adler32_rows_plain(data, ends, starts):
    """Plain torch version of adler32_rows: the reference's _adler32_impl
    tree (blocks of ADLER_BLOCK, pairs merged level by level, the
    right-padding correction at the end) with a batch dimension. Leading
    zeros are transparent to the S/W partials, since W's weight (length -
    i) is measured from the range's end."""
    bch, n = data.shape
    n_pad = max(ADLER_BLOCK, -(-n // ADLER_BLOCK) * ADLER_BLOCK)
    if n_pad != n:
        data = torch.cat([data, data.new_zeros((bch, n_pad - n))], dim=1)
    x, ends, starts = _row_window(data, ends, starts)
    s_total, w_pad, seg = _adler_tree(x, ADLER_BLOCK)
    return _adler_finish(s_total, w_pad, seg, ends, starts)


# ---------------------------------------------------------------------------
# 6. commit_walk (device decode's per-bit path)
# ---------------------------------------------------------------------------

# Bits a row and rows a superrow of the commit sweeps, as csrc/kernels.h's
# ZZ_COMMIT_ROW defines it (a test holds the two equal).
COMMIT_ROW = 256
_R = COMMIT_ROW
_RR = _R * _R


def commit_walk(step, start_bits, unit_valid, max_sup_span: int):
    """Exact token-boundary commit of the per-bit path: the (nbits,) bool
    mask of token starts each valid unit reaches from its start bit by
    next[p] = p + step[p], in the reference's row and superrow sweeps
    (zzflate_tpu/models/inflate_tpu.py _commit_walk, its quirks kept).

    step: (nbits,) int32 or int64, nbits a multiple of COMMIT_ROW^2 (and
    below 2^30 on the card), every step in [1, COMMIT_ROW] or above it (a
    stop: the decoder gives [1, 48] and 257); start_bits: (U,) int32 or
    int64, each valid one in [0, nbits); unit_valid: (U,) bool or int32;
    max_sup_span >= 0. On the card a step below 1 stops the walk, where
    the plain version follows the reference (csrc/kernels.h)."""
    for nm, t in (("step", step), ("start_bits", start_bits),
                  ("unit_valid", unit_valid)):
        if t.dim() != 1:
            raise ValueError(f"commit_walk: {nm} must be 1-D")
    nbits = step.shape[0]
    if nbits % _RR:
        raise ValueError(f"commit_walk: nbits must be a multiple of {_RR}")
    if unit_valid.shape != start_bits.shape:
        raise ValueError("commit_walk: start_bits and unit_valid differ")
    if max_sup_span < 0:
        raise ValueError("commit_walk: max_sup_span must be >= 0")
    if unit_valid.dtype != torch.bool:
        unit_valid = unit_valid != 0
    if not _route(step, start_bits, unit_valid):
        return commit_walk_plain(step, start_bits, unit_valid, max_sup_span)
    if nbits >= 1 << 30:
        raise ValueError("commit_walk: nbits must be below 2^30")
    for nm, t in (("step", step), ("start_bits", start_bits)):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"commit_walk: {nm} must be int32 or int64")
    dev = step.device
    # decode_candidates hands in int32 (a no-op); an int64 step is cast
    # once, read by each launch.
    step = step.to(torch.int32).contiguous()
    if step.data_ptr() % 16:
        step = step.clone()
    start = start_bits.to(torch.int32).contiguous()
    valid = unit_valid.contiguous().view(torch.uint8)
    u = start.shape[0]
    mark = torch.empty((nbits,), dtype=torch.uint8, device=dev)
    if nbits:
        sup_exit = torch.empty((nbits // _R,), dtype=torch.int32, device=dev)
        start_exit = torch.empty((max(u, 1),), dtype=torch.int32, device=dev)
        ents = torch.empty((max(u * max_sup_span, 1),), dtype=torch.int32,
                           device=dev)
        with torch.cuda.device(dev):
            rc = _load().zz_commit_walk(
                step.data_ptr(), nbits, start.data_ptr(), valid.data_ptr(),
                u, int(max_sup_span), sup_exit.data_ptr(),
                start_exit.data_ptr(), ents.data_ptr(), mark.data_ptr(),
                _stream(step))
        _raise_rc("commit_walk", rc)
        launches["commit_walk"] += 1
    # The kernel writes 0 or 1 a byte: the mark == 1 mask, read as bool.
    return mark.view(torch.bool)


def commit_walk_plain(step, start_bits, unit_valid, max_sup_span):
    """Plain torch version of commit_walk: the reference's five loops as
    about 4 * _R + max_sup_span short torch steps.

    step: (nbits,) per-bit token width (_HUGE stops the walk);
    start_bits: (U,) absolute first-token bit per block. Returns the
    (nbits,) bool committed mask. nbits must be a multiple of _R*_R."""
    dev = step.device
    step = step.long()
    nbits = step.shape[0]
    nrows = nbits // _R
    nsup = nbits // _RR
    sink = nbits

    # P1: exit-of-row for every bit (reverse sweep, _R steps).
    st_t = step.reshape(nrows, _R).T
    row_base = torch.arange(nrows, device=dev) * _R
    ex = torch.zeros((_R, nrows), dtype=torch.long, device=dev)
    for j in range(_R - 1, -1, -1):
        s = st_t[j]
        land = j + s
        hop = ex.gather(0, land.clamp(0, _R - 1)[None, :])[0]
        val = torch.where(
            s > _R, sink, torch.where(land >= _R, row_base + land, hop)
        )
        ex[j] = val.clamp(max=sink)
    exit1 = ex.T.reshape(-1)

    # P2a: exit-of-superrow for every bit (reverse sweep over rows).
    e1s = exit1.reshape(nsup, _R, _R)
    sup_end = (torch.arange(nsup, device=dev)[:, None] + 1) * _RR
    e2 = torch.zeros((nsup, _R, _R), dtype=torch.long, device=dev)
    e2f = e2.view(-1)
    for j in range(_R - 1, -1, -1):
        x1 = e1s[:, j, :]
        hop = e2f[x1.clamp(0, nbits - 1)]
        e2[:, j, :] = torch.where(x1 >= sup_end, x1, hop)
    exit2 = e2.reshape(-1)

    # P2b: per-block superrow chain (few steps, U lanes).
    e = torch.where(unit_valid, start_bits.long(), sink)
    ents = torch.full((max_sup_span, e.shape[0]), sink, dtype=torch.long,
                      device=dev)
    for k in range(max_sup_span):
        ents[k] = e
        e = torch.where(e >= sink, sink, exit2[e.clamp(0, nbits - 1)])

    # P2c: expand superrow entries to row entries (walk exit1 in-sup).
    pos = ents.reshape(-1)
    rent = torch.full((nrows + 1,), sink, dtype=torch.long, device=dev)
    for _ in range(_R):
        r = torch.where(pos < sink, pos // _R, nrows)
        rent.scatter_reduce_(0, r, pos, "amin")
        nxt = exit1[pos.clamp(0, nbits - 1)]
        same_sup = (nxt // _RR) == (pos // _RR)
        pos = torch.where((pos < sink) & same_sup, nxt, sink)

    # P3: mark committed token starts (every entered row, _R steps).
    pos = rent[:nrows]
    mark = torch.zeros((nbits + 1,), dtype=torch.long, device=dev)
    for _ in range(_R):
        active = pos < sink
        mark.scatter_reduce_(0, pos.clamp(0, nbits), active.long(), "amax")
        pc = pos.clamp(0, nbits - 1)
        nxt = pos + step[pc]
        row_end = (pc // _R + 1) * _R
        pos = torch.where(active & (nxt < row_end), nxt, sink)
    return mark[:nbits] == 1


# ---------------------------------------------------------------------------
# 7. token_scatter and resolve_lz (device decode's LZ tail)
# ---------------------------------------------------------------------------

# The resolve's launch shape and round cap, as csrc/kernels.h defines them
# (a test holds the two equal): blocks of RESOLVE_THREADS threads scan
# tiles of RESOLVE_TILE positions, each warp RESOLVE_STEPS runs of 32; at
# most RESOLVE_ROUNDS doubling rounds, the reference's cap.
RESOLVE_THREADS = 256
RESOLVE_STEPS = 16
RESOLVE_TILE = RESOLVE_THREADS * RESOLVE_STEPS
RESOLVE_ROUNDS = 40
_SCAN_ROW = 2048  # row length of cummax's two-level running max


def cummax(x):
    """Inclusive running max of a 1-D integer tensor (the values of
    torch.cummax). torch scans a 1-D tensor as a single row, serially on
    the card (12 ms at 2^22 on the H100); as rows of _SCAN_ROW scanned
    in parallel, then a short scan of the row maxima carried into the
    next rows, the values are the same."""
    n = x.shape[0]
    if n <= _SCAN_ROW:
        return torch.cummax(x, 0).values
    rows = -(-n // _SCAN_ROW)
    pad = x.new_full((rows * _SCAN_ROW - n,), torch.iinfo(x.dtype).min)
    m = torch.cummax(torch.cat([x, pad]).view(rows, _SCAN_ROW), 1).values
    carry = torch.cummax(m[:, -1], 0).values
    m[1:] = torch.maximum(m[1:], carry[:-1, None])
    return m.view(-1)[:n]


def token_scatter(litval, start_mark, dist_at, off, committed, islit, islen,
                  sym, mdist):
    """The per-bit path's committed tokens into the three output-space
    arrays, in place: for every bit b with committed[b] & (islit[b] |
    islen[b]) and 0 <= off[b] < n_out_pad, litval[off] = max(litval[off],
    islit ? sym : 0), start_mark[off] = max(start_mark[off], off) and
    dist_at[off] = max(dist_at[off], islen ? mdist : 0), each field maxed
    on its own as the reference's .at[tgt].max(mode="drop") does
    (zzflate_tpu/models/inflate_tpu.py:628-636). Other bits change
    nothing. Returns (litval, start_mark, dist_at).

    litval, start_mark, dist_at: (n_out_pad,) int32; off, sym, mdist:
    (nbits,) int64 or int32, sym and mdist within int32 (the kernel reads
    off as int64 and sym and mdist as int32, as the decoder hands them);
    committed, islit, islen: (nbits,) bool."""
    for nm, t in (("litval", litval), ("start_mark", start_mark),
                  ("dist_at", dist_at)):
        _check(nm, t, 1)
    if start_mark.shape != litval.shape or dist_at.shape != litval.shape:
        raise ValueError("token_scatter: output arrays differ in shape")
    ins = (("off", off), ("committed", committed), ("islit", islit),
           ("islen", islen), ("sym", sym), ("mdist", mdist))
    for nm, t in ins:
        if t.dim() != 1 or t.shape != off.shape:
            raise ValueError(f"token_scatter: {nm} must be 1-D like off")
        want = ((torch.bool,) if nm in ("committed", "islit", "islen")
                else (torch.int32, torch.int64))
        if t.dtype not in want:
            raise TypeError(f"token_scatter: {nm} must be {want}")
    args = (litval, start_mark, dist_at, off, committed, islit, islen, sym,
            mdist)
    if not _route(*args):
        return token_scatter_plain(*args)
    nbits, n_out_pad = off.shape[0], litval.shape[0]
    if nbits >= 1 << 31 or n_out_pad >= 1 << 31:
        raise ValueError("token_scatter: nbits and n_out_pad must be "
                         "below 2^31")
    off = off.to(torch.int64).contiguous()
    sym, mdist = (t.to(torch.int32).contiguous() for t in (sym, mdist))
    committed, islit, islen = (t.contiguous().view(torch.uint8)
                               for t in (committed, islit, islen))
    if nbits and n_out_pad:
        with torch.cuda.device(off.device):
            rc = _load().zz_token_scatter(
                off.data_ptr(), committed.data_ptr(), islit.data_ptr(),
                islen.data_ptr(), sym.data_ptr(), mdist.data_ptr(), nbits,
                litval.data_ptr(), start_mark.data_ptr(), dist_at.data_ptr(),
                n_out_pad, _stream(off))
        _raise_rc("token_scatter", rc)
        launches["token_scatter"] += 1
    return litval, start_mark, dist_at


def token_scatter_plain(litval, start_mark, dist_at, off, committed, islit,
                        islen, sym, mdist):
    """Plain torch version of token_scatter: scatter_reduce_("amax") over
    every bit, the dropped ones aimed at a trash slot past the end."""
    n_out_pad = litval.shape[0]
    off, sym, mdist = off.long(), sym.long(), mdist.long()
    com_tok = committed & (islit | islen)
    tgt = torch.where(com_tok & (off >= 0) & (off < n_out_pad), off,
                      n_out_pad)

    def scatter_max(base, vals):
        buf = torch.cat([base.long(), base.new_zeros(1).long()])
        buf.scatter_reduce_(0, tgt, vals, "amax")
        return buf[:n_out_pad]

    litval.copy_(scatter_max(litval, torch.where(islit, sym, 0)))
    start_mark.copy_(scatter_max(start_mark, torch.where(com_tok, off, -1)))
    dist_at.copy_(scatter_max(dist_at, torch.where(islen, mdist, 0)))
    return litval, start_mark, dist_at


def resolve_lz(litval, start_mark, dist_at):
    """LZ resolve of one group (zzflate_tpu/models/inflate_tpu.py
    _resolve_parent and _resolve_lz): every position's source chased to
    its literal (resolve_parent), then the (n,) uint8 bytes
    litval[parent] & 0xFF. litval, start_mark, dist_at: (n,) int32."""
    for nm, t in (("litval", litval), ("start_mark", start_mark),
                  ("dist_at", dist_at)):
        _check(nm, t, 1)
    if start_mark.shape != litval.shape or dist_at.shape != litval.shape:
        raise ValueError("resolve_lz: arrays differ in shape")
    if not _route(litval, start_mark, dist_at):
        return resolve_lz_plain(litval, start_mark, dist_at)
    return _resolve_launch(litval, start_mark, dist_at)[0]


def resolve_parent(start_mark, dist_at):
    """The resolve's source chase alone: (parent, rounds), every
    position's ultimate literal source and the doubling rounds taken (the
    reference's while_loop, capped at RESOLVE_ROUNDS). start_mark,
    dist_at: (n,) int32. On the card the resolve_lz kernel runs without
    its byte gather and returns parent as (n,) int32 and rounds as a (1,)
    int32 tensor on the card (reading it synchronises); the plain version
    returns int64 and an int."""
    for nm, t in (("start_mark", start_mark), ("dist_at", dist_at)):
        _check(nm, t, 1)
    if dist_at.shape != start_mark.shape:
        raise ValueError("resolve_parent: arrays differ in shape")
    if not _route(start_mark, dist_at):
        return resolve_parent_plain(start_mark, dist_at)
    return _resolve_launch(None, start_mark, dist_at)[1:]


def _resolve_launch(litval, start_mark, dist_at):
    """The resolve_lz kernel: (out or None, parent, rounds)."""
    n = start_mark.shape[0]
    if n > 1 << 30:
        raise ValueError("resolve_lz: at most 2^30 positions")
    dev = start_mark.device
    parent = torch.empty((n,), dtype=torch.int32, device=dev)
    out = (None if litval is None
           else torch.empty((n,), dtype=torch.uint8, device=dev))
    if not n:
        # The reference's loop takes one round of an empty array.
        return out, parent, torch.ones((1,), dtype=torch.int32, device=dev)
    scratch = torch.empty_like(parent)
    tmax = torch.empty((-(-n // RESOLVE_TILE),), dtype=torch.int32,
                       device=dev)
    flags = torch.empty((RESOLVE_ROUNDS + 1,), dtype=torch.int32, device=dev)
    rounds = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _load().zz_resolve_lz(
            None if litval is None else litval.data_ptr(),
            start_mark.data_ptr(), dist_at.data_ptr(), n, parent.data_ptr(),
            scratch.data_ptr(), tmax.data_ptr(), flags.data_ptr(),
            None if out is None else out.data_ptr(), rounds.data_ptr(),
            _stream(start_mark))
    _raise_rc("resolve_lz", rc)
    launches["resolve_lz"] += 1
    return out, parent, rounds


def resolve_parent_plain(start_mark, dist_at):
    """Plain torch version of resolve_parent: covering token via cummax,
    then pointer doubling with a convergence test and a host sync a
    round. Returns (parent, rounds): every position's ultimate literal
    source index, and the doubling rounds taken (at most 40, the
    reference's cap, so a hostile stream stops where it stops).

    The first hop is the closed-form in-token source: a match starting
    at s with distance d repeats its source with period d, so position
    i's ultimate within-token source is s - d + ((i - s) mod d), one hop
    that lands strictly before the token start. Overlapped copies
    therefore collapse to depth 1; remaining chains are nested tokens."""
    n_out_pad = start_mark.shape[0]
    dev = start_mark.device
    idx = torch.arange(n_out_pad, device=dev)
    seg = cummax(start_mark.long())
    dist = dist_at.long()[seg.clamp(0, n_out_pad - 1)]
    d1 = dist.clamp(min=1)
    src = seg - d1 + (idx - seg) % d1
    parent = torch.where((dist > 0) & (seg >= 0), src, idx)
    parent = parent.clamp(0, n_out_pad - 1)
    rounds = 0
    changed = True
    while changed and rounds < RESOLVE_ROUNDS:
        p2 = parent[parent]
        changed = bool((p2 != parent).any())
        parent = p2
        rounds += 1
    return parent, rounds


def resolve_lz_plain(litval, start_mark, dist_at):
    """Plain torch version of resolve_lz."""
    parent, _rounds = resolve_parent_plain(start_mark, dist_at)
    return litval[parent].to(torch.uint8)


# ---------------------------------------------------------------------------
# 8. decode_candidates (device decode's per-bit path)
# ---------------------------------------------------------------------------

# The candidate kernel's launch shape, as csrc/kernels.h defines it (a test
# holds the two equal): blocks of CAND_THREADS threads, each thread
# CAND_BITS consecutive bits.
CAND_THREADS = 256
CAND_BITS = 4
_LUT_UNITS = 64  # units a LUT build of the plain version takes at once


def decode_candidates(words, ll, d, start_bits, unit_valid, nbits: int):
    """The per-bit path's candidate token at every bit of a group
    (zzflate_tpu/models/inflate_tpu.py _decode_all :593-612: _build_luts,
    _bit_windows, the owning-unit scatter and scan, _decode_bits). Returns
    (uid, step, outlen, sym, mdist, islit, islen): five (nbits,) int32 and
    two (nbits,) bool. uid[b] = max{u : unit_valid[u], start_bits[u] <= b}
    (a start below 0 counts as 0, one at or past nbits is dropped), else
    0; the rest is the token that would start at b in unit uid[b]'s
    tables: step its width, or _HUGE (257) at an EOB or an invalid window;
    sym and mdist as the reference's LUT path computes them at every bit.

    words: (nbits / 32 + 2,) int32 carrying u32 bits, nbits a multiple of
    32; ll = (first, cnt, off, sym) of (U, 16) x3 and (U, 288) int32, d the
    same with (U, 32); start_bits: (U,) int32 or int64; unit_valid: (U,)
    bool; U >= 1. The tables' symbols lie in [0, 288) and [0, 32), as the
    host plan makes them; outside them the plain version raises."""
    if words.dim() != 1:
        raise ValueError("decode_candidates: words must be 1-D")
    if nbits < 0 or nbits % 32 or words.shape[0] != nbits // 32 + 2:
        raise ValueError("decode_candidates: nbits must be a multiple of 32 "
                         "and words hold nbits / 32 + 2 entries")
    u = start_bits.shape[0]
    if start_bits.dim() != 1 or u < 1 or unit_valid.shape != start_bits.shape:
        raise ValueError("decode_candidates: start_bits and unit_valid must "
                         "be (U,) with U >= 1")
    if unit_valid.dtype != torch.bool:
        raise TypeError("decode_candidates: unit_valid must be bool")
    if len(ll) != 4 or len(d) != 4:
        raise ValueError("decode_candidates: ll and d are (first, cnt, off, "
                         "sym)")
    for (nm, rows), width in zip((("ll", ll), ("d", d)), (_MAX_LL, _MAX_D)):
        for k, t in enumerate(rows):
            want = (u, 16 if k < 3 else width)
            if tuple(t.shape) != want:
                raise ValueError(f"decode_candidates: {nm}[{k}] must be "
                                 f"{want}, got {tuple(t.shape)}")
    if not _route(words, *ll, *d, start_bits, unit_valid):
        return decode_candidates_plain(words, ll, d, start_bits, unit_valid,
                                       nbits)
    if nbits >= 1 << 30:
        raise ValueError("decode_candidates: nbits must be below 2^30")
    _check("words", words, 1)
    for nm, rows in (("ll", ll), ("d", d)):
        for t in rows:
            _check(nm, t, 2)
    if start_bits.dtype not in (torch.int32, torch.int64):
        raise TypeError("decode_candidates: start_bits must be int32 or "
                        "int64")
    dev = words.device
    start = start_bits.to(torch.int32).contiguous()
    valid = unit_valid.contiguous().view(torch.uint8)
    hi = torch.empty((u * 32,), dtype=torch.int32, device=dev)
    outs = [torch.empty((nbits,), dtype=torch.int32, device=dev)
            for _ in range(5)]
    flags = [torch.empty((nbits,), dtype=torch.uint8, device=dev)
             for _ in range(2)]
    if nbits:
        with torch.cuda.device(dev):
            rc = _load().zz_decode_candidates(
                words.data_ptr(), nbits, *(t.data_ptr() for t in ll + d),
                _on_device("ll_attr", dev).data_ptr(),
                _on_device("d_attr", dev).data_ptr(), start.data_ptr(),
                valid.data_ptr(), u, hi.data_ptr(),
                *(t.data_ptr() for t in outs + flags), _stream(words))
        _raise_rc("decode_candidates", rc)
        launches["decode_candidates"] += 1
    # The kernel writes 0 or 1 a byte: the flags read as bool.
    return (*outs, *(f.view(torch.bool) for f in flags))


def decode_candidates_plain(words, ll, d, start_bits, unit_valid,
                            nbits: int):
    """Plain torch version of decode_candidates: the reference's chain as
    int64 torch ops (two (U, 2^15) LUTs, built _LUT_UNITS units at a time
    to bound the temporaries; the bit windows, the owning unit, the LUT
    decode), cast to the kernel's types at the end."""
    dev = words.device

    def luts(rows, attr, nsym, sym_bits):
        return torch.cat([
            _build_luts(*(t[k:k + _LUT_UNITS] for t in rows), attr, nsym,
                        sym_bits)
            for k in range(0, rows[0].shape[0], _LUT_UNITS)])

    ll_lut = luts(ll, _on_device("ll_attr", dev), _MAX_LL, 10)
    d_lut = luts(d, _on_device("d_attr", dev), _MAX_D, 5)
    win_lo, win_hi = _bit_windows(words)
    # The owning unit (inflate_tpu.py:603-608): unit ids scattered with max
    # at their start bits (an invalid unit or a start at or past nbits
    # dropped), then a running max.
    tgt = torch.where(unit_valid, start_bits.long(), nbits)
    uid0 = torch.zeros((nbits + 1,), dtype=torch.long, device=dev)
    uid0.scatter_reduce_(0, tgt.clamp(0, nbits),
                         torch.arange(start_bits.shape[0], device=dev),
                         "amax")
    uid = cummax(uid0[:nbits])
    step, outlen, sym, mdist, islit, islen, _eob = _decode_bits(
        win_lo, win_hi, uid, ll_lut, d_lut)
    return (uid.int(), step.int(), outlen.int(), sym.int(), mdist.int(),
            islit, islen)
