#!/usr/bin/env python3
"""Drive the zzflate_tpu_torch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing is caught):

1. card: the device name, nvidia-smi's name and power limit, the nvcc
   build of the nine kernel sources from zzflate_tpu_torch/csrc (one nvcc per
   source, all started together) and the host C compiler's build of the
   port's C runtime (zzflate_tpu_torch/native);
2. kernels: at the main-path shape (16, 294912) each kernel is held
   against its plain torch version on the card, on seeded inputs and on
   the arrays the main path's L6, L1 and L9 calls and an L7 and an L8
   call (two batches each) hand it (their order-B scans run K=20, 24
   and 32 both ways, the runtime-K instance); equality must be exact
   (the codec is integer-only). parse_rows
   and propagate_matches also on an input off that shape;
   propagate_matches also on lengths up to 65 535, an all-match row, and
   lengths 514 and 515 at the window's edge. Device times: the kernel
   (parse_rows also per launch: exits, marks; scan_candidates and
   propagate_matches on each of their real launches, with the bound and
   the share of it), the plain version, the bound, and for
   propagate_matches a library yardstick. optimal_dp (the level 7-9
   optimal parse's DP; no plain version, its oracle is the host C DP):
   every launch of the L7, L8 and L9 calls, each row's choices walked as
   the C DP walks its own and held exactly to native.optimal_parse on the
   same matches and pass-1 code lengths, every position outside a row's
   range 0; its device time on each level's last launch with the bytes
   bound, the share and ns a step (a row is a chain of dependent steps,
   which the bytes bound does not see); then, on the main path's first L9
   batch, the card's override (the kernel, parse_rows, the histograms,
   the freqs copy and the re-plan) equal to the C DP path's and both
   timed on the host clock;
3. main path: compress() on a seeded 8 MiB corpus at level 6 gzip,
   level 1 zlib and level 9 gzip (the optimal parse's DP on the card)
   with 256 KiB chunks; each output must decode to the input with stdlib
   zlib and with the port's own decompress(), every matcher kernel must
   have launched in each level's run and optimal_dp once a batch at L9
   and never at L6 or L1 (counts reset just before its first timed call,
   read just after). The median time of MAIN_REPS calls,
   MB/s, size against zlib levels 6 and 9, stage times (a separate run)
   and a torch.profiler trace (another run: device time by kernel, the
   card's idle share) are printed;
4. streaming: the 8 MiB corpus through zlib_compat.compressobj(6,
   wbits=31) in 64 KiB pieces, then Z_FINISH, on the card: one
   encode_segments call, one (1, 294912) batch, per 256 KiB chunk. The
   output must decode with stdlib gzip and with stream.Decompressor fed
   in 64 KiB pieces, and every kernel must launch in the streamed run
   (counts reset just before the first timed call, read just after).
   The median of STREAM_REPS calls in MB/s beside phase 3's one-shot L6
   gzip, size against zlib-6, stage times, a trace with the card's idle
   share, the host Decompressor's MB/s, and gzip_compat.GzipFile
   (engine="device") writing the 8 MiB in 1 MiB writes, decoded by
   stdlib gzip. Phase 2 also holds and times the kernels' launches of
   the stream's first full chunk;
5. reference bytes: a 1 MiB prefix at levels 6 and 9 on the card equals
   the port's CPU path, and a fixed 64 KiB input with 4 KiB chunks
   hashes to REF_SHA256_L6_4K at level 6 and REF_SHA256_L9_4K at level
   9, the digests the JAX reference produces (asserted by
   tests/test_torch_api.py); stream_script on the 1 MiB prefix gives
   the CPU path's bytes on every call, and on the 64 KiB input with 4
   KiB chunks hashes to REF_SHA256_STREAM_4K (asserted against the
   reference by tests/test_torch_stream.py).

6. device decode: the 8 MiB corpus compressed by the port on the card
   (L6 gzip, indexed, 256 KiB chunks: 3 groups) and by stdlib zlib at
   level 6 as zlib, gzip and raw, each decoded by
   decompress(engine="device") to the input, with the anchor walk
   launched in each run (counts reset just before the first timed call,
   read just after); the CRC checked on the card by crc32_rows (gzip,
   indexed: launched in each run), the Adler-32 on the host (zlib). The
   median MB/s of DECODE_REPS calls beside the host C decoder's on the
   same bytes, stage times, a trace of one indexed call (device time by
   kernel, idle share), the LZ resolve's doubling rounds, the device
   launches and time of one 4 MiB group's CRC (at most 3); a flipped
   payload byte raises ValueError on the card; a 64 MiB corpus decodes
   with to_device=True to a CUDA tensor equal to the input, DECODE_REPS
   times, as an indexed stream (whose index drops its anchors at that
   size, so the per-bit path runs: the commit kernel launched once a
   group) and as a stdlib gzip stream (the walk), the CRC kernel launched
   in both, MB/s and stages beside the host C decoder's. The
   walk kernel equals its plain version exactly on the first group of
   the indexed run and of the gzip run (at FOREIGN_ANCHOR_TOKENS) and on
   two seeded inputs (invalid windows, the fixed code's reserved
   symbols, an incomplete code's windows past the tree and distances 30
   and 31, lanes past the body and past the output's end). For every
   launch of those two runs: its time with its bound and share, its
   lanes, blocks (each on one SM) and the units a block spans, and its
   first lane alone at t_steps and at half of it, which give ns a step
   and the chain floor. A 1 MiB v2 index (per-bit path, no walk) decodes
   DECODE_REPS times: MB/s beside the host C decoder's, stages, and the
   device time of one group's _decode_all split into the commit kernels'
   and the rest. The commit walk (csrc/commit.cu) launches in both
   per-bit runs (once a group) and in no walk run, and equals its plain
   version exactly on every group of the v2 run, the first and last
   group of the 64 MiB per-bit run, and the seeded cases of
   corpus.commit_walk_inputs at 2 and 4 superrows and a group's 4 194 304
   bits (random steps with stops, several units and an invalid one,
   starts at bit 0, in the last row and on the last bit, blocks across
   superrows, max_sup_span at its cap and below it, steps up to 256, and
   the reference's shared-row case). Per real group: the kernel's time
   (L2 flushed, median of 15), its bytes and operations bound and share,
   the serial depth, the device launches of a call against the plain
   version's, and the plain version's time; and the kernel alone on one
   superrow with one unit (its serial depth's floor). The LZ tail
   (csrc/resolve.cu): resolve_lz launches once a group on every run and
   token_scatter once a group on the per-bit runs (never on the walk);
   resolve_lz equals its plain version exactly (bytes, parents and the
   doubling rounds, read from the card after the call) on every group of
   the indexed, zlib, gzip and raw runs and the first and last groups of
   both 64 MiB runs and the v2 run, token_scatter on the v2 group and the
   64 MiB per-bit run's first and last, and both on the seeded cases of
   corpus.resolve_inputs and scatter_inputs at a group's size (a distance-1
   chain 2^20 deep and one as long as the group, tokens on prefix and
   stored slots, two writes to one slot, offsets at and past the end).
   Per real group: each kernel's time (L2 flushed, median of 15), its
   bytes bound and share, the plain version's time, the rounds; for
   token_scatter also the three scatter_reduce_ calls it replaced (its
   library yardstick), each alone with the trash slot and filtered to the
   committed tokens. The candidate decode (csrc/candidates.cu):
   decode_candidates launches once a group on both per-bit runs and never
   on a walk run or in an encode run, and equals its plain version exactly
   (every output at every bit) on the seeded cases of
   corpus.candidate_inputs at 65 536, 131 072 and 4 194 304 bits (random
   words, the fixed code's litlen 286/287, an incomplete code with
   distance symbols 30/31, EOBs on the last bits, starts unsorted,
   repeated, at 0, at nbits - 1 and past the end, padding units, U = 1 and
   1 024), on the v2 group and on the 64 MiB per-bit run's first and last
   groups, each real group timed (L2 flushed, median of 15) with its bytes
   and operations bound, share and the plain version's time. One v2
   group's _decode_all: its device launches (at most 100) and time split
   into the candidate kernels, the commit kernels, token_scatter,
   resolve_lz's and the rest, and by stage (lz_tail_bench.stage_split:
   the stages of one profiled call, each in a range of its own; either
   profile without device records fails the phase), its wall time, and a
   run under
   torch.cuda.set_sync_debug_mode("error") (as the walk path's resolve).

7. parallel: a seeded 64 MiB corpus at L6 gzip, 256 KiB chunks (256
   chunks), through parallel.compress_sharded on make_mesh() (every
   visible card) and on the first card named twice (the row split, each
   device's partials and their merge run even on one card). The bytes
   must equal compress() on one card and decode with stdlib gzip, the
   trailer's CRC (combined from the card's per-chunk partials) must
   equal zlib.crc32, and all three matcher kernels and both checksum
   kernels must launch in each layout's run (counts reset just before,
   read just after). Median MB/s of PAR_REPS calls beside the one-card
   one-shot's, stage times (analyze includes the partials), make_mesh's
   trace and idle share, and the partials' own device time and launches
   (at most 6) on one batch. The cases of
   __graft_entry__.dryrun_multichip on the card named 8 times (256 KiB
   chunks, mem_level=1, an uneven tail, an incompressible chunk taking
   the stored fallback; indexed + seekable with a decompress_range
   read). Then parallel.compress_multihost in 2 and in 3 spawned
   processes over gloo (this script with --multihost-worker), each on
   its own card (cuda:rank % count: here all share one) with a
   chunk-aligned range of the 64 MiB: root's bytes must equal the
   single-process bytes and decode with stdlib gzip, and every process
   must report all five encode kernels launched. The wall time from a
   barrier to root's return, median of PAR_REPS calls in the same
   processes, as aggregate MB/s beside one process's.

8. checksum kernels: crc32_rows and adler32_rows (csrc/checksum.cu)
   each held exactly against its plain version and zlib on the real
   decode groups that phase 6's indexed and gzip runs checked, on phase
   7's partials batch, on a hostile batch (empty ranges at 0, inside and
   at N, lengths 1-4, start > 0 with end < N, ranges across a block edge,
   odd width 37 197; by tensor bounds and by one shared range) and on a
   single row of 64 MiB + 5 B; each kernel's time per launch (L2 flushed,
   median of 15) on a decode group, the partials batch and the 64 MiB
   row, with its bytes and operations bound and share, the plain
   version's time; no PyTorch call computes either (library: none).

Every trace goes through utils.profiling.trace, which also writes it
gzipped to chiprun_out/traces/. The second-to-last lines are the
kernels JSON (the eleven kernels, each with its launches by run under
"launches_by_level" or "launches_by_run", the phase 7 paths among them,
and phase 7's MB/s and partials under "parallel") and nvidia-smi's line;
the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import gzip
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
import zlib

MAIN_BYTES = 8 << 20
# Chrome traces of the profiled calls (gzipped; gitignored).
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "chiprun_out", "traces")
MAIN_CHUNK = 1 << 18
MAIN_REPS = 5  # timed compress() calls per level
MAIN_RUNS = ((6, "gzip"), (1, "zlib"), (9, "gzip"))  # (level, format)
STREAM_PIECE = 1 << 16  # bytes per compress() call of the streamed runs
STREAM_REPS = 3  # timed streamed runs
# Phase 2 also takes L7's and L8's launches: their scans run K=20 and 24.
KERNEL_RUNS = MAIN_RUNS + ((7, "gzip"), (8, "gzip"))
BATCH = 16  # chunks per device batch on the main path
MAIN_BATCHES = -(-MAIN_BYTES // (MAIN_CHUNK * BATCH))  # batches of a call
REF_INPUT_BYTES = 1 << 16
REF_INPUT_SEED = 7
REF_SHA256_L6_4K = "5fb898053468dc47e80f13c50044f253ad40d6dc18c3b0f6b6d19f4149f7f15e"
REF_SHA256_L9_4K = "b15bf0e7a7b67912b3b05250feb1c0a9463f2aec6fd94745db5b6e324a091233"
# stream_script at level 6 gzip, 4 KiB chunks, 4 KiB pieces, on the same
# 64 KiB input.
REF_SHA256_STREAM_4K = "3306d291b7d8320e09a78c395741ea67fff581e5dd1ded45d60c9ed0f7fb9341"
DECODE_REPS = 3  # timed decode calls per stream
DECODE_BIG = 64 << 20  # the data-loading runs: to_device=True
V2_BYTES = 1 << 20  # the per-bit path's stream (v2 index)

PAR_BYTES = 64 << 20  # phase 7: the sharded and multi-process runs
PAR_REPS = 3  # timed calls per layout / process count
MH_PROCS = (2, 3)  # processes of the multi-process runs, one card each
# (cuda:rank % count: on a one-card machine they share it)
MH_TIMEOUT = 300  # seconds a multi-process run may take in all

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# H100 SXM 32-bit integer rate: the compare, select, min and add work of
# the bounds runs on the integer pipe, 64 lanes per SM (not the 128 fp32
# lanes, nor an FMA counted twice): 132 SMs x 64 lanes x 1.98 GHz.
INT_OPS_PER_S = 132 * 64 * 1.98e9  # 16.7e12 op/s

KERNELS = {
    # name: (source, TPU kernel replaced)
    "scan_candidates": ("zzflate_tpu_torch/csrc/scan.cu",
                        "zzflate_tpu/ops/pallas_kernels.py:37"),
    "propagate_matches": ("zzflate_tpu_torch/csrc/propagate.cu",
                          "zzflate_tpu/ops/pallas_kernels.py:174"),
    "parse_rows": ("zzflate_tpu_torch/csrc/parse.cu",
                   "zzflate_tpu/ops/pallas_kernels.py:267"),
}
# The level 7-9 optimal parse's DP: no Pallas kernel, the reference's
# host C DP.
OPTIMAL = ("optimal_dp", "zzflate_tpu_torch/csrc/optimal.cu",
           "zzt_optimal_parse, zzflate_native.c:762 (the host C DP, called "
           "from zzflate_tpu/encode_policy.py optimal_override)")
OPT_LEVELS = (7, 8, 9)
OPT_BYTES_POS = 13  # a parsed position: data, mlen, mdist read, choice written
OVERRIDE_REPS = 3  # host-clock calls of each override
# Device decode's kernel: no Pallas kernel, the reference's lax.fori_loop.
WALK = ("anchor_walk", "zzflate_tpu_torch/csrc/walk.cu",
        "zzflate_tpu/models/inflate_tpu.py:727 (_walk_core, lax.fori_loop)")
# Device decode's per-bit path: no Pallas kernel, the reference's five
# lax.fori_loops.
COMMIT = ("commit_walk", "zzflate_tpu_torch/csrc/commit.cu",
          "zzflate_tpu/models/inflate_tpu.py:477 (_commit_walk, five "
          "lax.fori_loops at :505, :521, :537, :555, :572)")
# Integer operations of the commit walk: P1 reads a bit's code, adds,
# compares and selects (4), P2a reads, compares and selects (3), P3 reads,
# marks and advances a committed token (4). P2c's hops are left out, so
# the bound stays a lower one.
COMMIT_OPS_BIT = 7
COMMIT_OPS_MARK = 4
# Device decode's LZ tail: no Pallas kernels, the reference's scatters in
# _decode_all and its lax.while_loop.
SCATTER = ("token_scatter", "zzflate_tpu_torch/csrc/resolve.cu",
           "zzflate_tpu/models/inflate_tpu.py:628 (_decode_all's three "
           ".at[tgt].max(mode=\"drop\"), :628-636)")
# Device decode's candidate tokens: no Pallas kernel, the candidate stage
# of the reference's jitted _decode_all.
CAND = ("decode_candidates", "zzflate_tpu_torch/csrc/candidates.cu",
        "zzflate_tpu/models/inflate_tpu.py:593-612 (_decode_all's candidate "
        "stage: _build_luts :281, _bit_windows :330, uid :603-608, "
        "_decode_bits :353)")
CAND_SIZES = (1 << 16, 1 << 17, 1 << 22)  # the seeded cases' sizes, bits
DECODE_ALL_MAX_LAUNCHES = 100  # device launches of one per-bit group
RESOLVE = ("resolve_lz", "zzflate_tpu_torch/csrc/resolve.cu",
           "zzflate_tpu/models/inflate_tpu.py:683 (_resolve_parent, its "
           "lax.while_loop at :716) and :722 (_resolve_lz)")
# The checksums over row ranges: no Pallas kernels, the reference's jitted
# programs (vmapped by its encoder, run per group by its device decode).
CHECKSUMS = {
    "crc32_rows": ("zzflate_tpu_torch/csrc/checksum.cu",
                   "zzflate_tpu/ops/checksums.py:245 (_crc32_impl, jit)"),
    "adler32_rows": ("zzflate_tpu_torch/csrc/checksum.cu",
                     "zzflate_tpu/ops/checksums.py:174 (_adler32_impl, jit)"),
}
# Integer operations a byte that each function needs: a table CRC xors the
# byte into the state, masks the index, shifts the state and xors the
# entry in; Adler adds the byte to s and multiply-adds it into w.
CKS_OPS_PER_BYTE = {"crc32_rows": 4, "adler32_rows": 2}
CKS_BIG = (64 << 20) + 5  # phase 8's single long row
CKS_ODD_WIDTH = 37197  # phase 8's hostile batch


def log(*parts) -> None:
    print(*parts, flush=True)


def stream_script(comp, data: bytes, piece: int) -> list[bytes]:
    """Drive a stream.Compressor (the port's or the reference's) through
    every flush mode: the first quarter of `data` in `piece`-byte pieces
    and Z_SYNC_FLUSH, the second and Z_FULL_FLUSH, 1001 bytes and a
    Z_BLOCK that must leave the stream mid-byte, a quarter more arriving
    mid-byte, set_params(level=9), the rest and Z_FINISH. Returns the
    output of every call."""
    n = len(data)
    outs = []

    def feed(lo, hi):
        for off in range(lo, hi, piece):
            outs.append(comp.compress(data[off : min(off + piece, hi)]))

    feed(0, n // 4)
    outs.append(comp.flush(zlib.Z_SYNC_FLUSH))
    feed(n // 4, n // 2)
    outs.append(comp.flush(zlib.Z_FULL_FLUSH))
    feed(n // 2, n // 2 + 1001)
    outs.append(comp.flush(zlib.Z_BLOCK))
    if not comp._tail_n:
        raise AssertionError("stream script: Z_BLOCK left no sub-byte tail")
    feed(n // 2 + 1001, 3 * n // 4 + 1001)
    outs.append(comp.set_params(level=9))
    feed(3 * n // 4 + 1001, n)
    outs.append(comp.flush(zlib.Z_FINISH))
    return outs


@contextlib.contextmanager
def capture(kernels, calls: dict):
    """Record every kernel wrapper's arguments while the body runs."""
    orig = {name: getattr(kernels, name) for name in (*KERNELS, OPTIMAL[0])}

    def make(name):
        def wrapped(*args):
            calls.setdefault(name, []).append(args)
            return orig[name](*args)
        return wrapped

    for name in orig:
        setattr(kernels, name, make(name))
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(kernels, name, fn)


def max_abs_err(torch, a, b) -> int:
    if isinstance(a, tuple):
        return max(max_abs_err(torch, x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def seeded_inputs(torch, n: int, seed: int):
    """Seeded (BATCH, n) inputs of every kernel, made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def ri(lo, hi, shape=(BATCH, n)):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    adj = ri(0, 65)
    spos = torch.argsort(torch.rand((BATCH, n), generator=g, device=dev),
                         dim=1).int()
    ws = ri(0, 32769, (BATCH,))
    # Propagation: lengths up to 400 exercise the 512-wide window, a few up
    # to 65 535 the domain's edge. Row 0 is all matches. Row 1 holds only a
    # length of 514 at 100 (length 3 at k = 511: kept) and one of 515 at
    # 2000 (length 3 at k = 512, one past the window: not carried).
    mlen = torch.where(torch.rand((BATCH, n), generator=g, device=dev) < 0.4,
                       ri(3, 401), 0)
    mlen = torch.where(torch.rand((BATCH, n), generator=g, device=dev) < 0.02,
                       ri(3, 65536), mlen)
    mlen[0] = ri(3, 259, (n,))
    mlen[1] = 0
    mlen[1, 100] = 514
    mlen[1, 2000] = 515
    pk = torch.where(mlen > 0, (mlen << 15) | (32768 - ri(1, 32769)), 0).int()
    # Off the main-path shape: n not a multiple of 512 or of the tile, and
    # n % 4 == 3 (4-byte loads and stores).
    edge_pk = pk[:, : n - 1001].contiguous()
    step = torch.where(torch.rand((BATCH, n), generator=g, device=dev) < 0.3,
                       ri(3, 259), 1).int()
    starts = ri(0, 40000, (BATCH,))
    # Off the main-path shape: 570 rows per chunk (not a multiple of the
    # 32-row segment) and every chunk starting at 0.
    edge_step = step[:, : 570 * 512].contiguous()
    edge_starts = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
    return {
        "scan_candidates": [(adj, spos, ws, 16, 64, False),
                            (adj, spos, ws, 8, 16, True)],
        "propagate_matches": [(pk,), (edge_pk,)],
        "parse_rows": [(step, starts, 512), (edge_step, edge_starts, 512)],
    }


def phase_card(torch, kernels, native):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {name} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    path = kernels.build()
    log(f"build: {time.perf_counter() - t0:.3f} s -> {path.name}")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  ptxas {line.strip()}")
    t0 = time.perf_counter()
    native.lib()
    log(f"C runtime build: {time.perf_counter() - t0:.3f} s -> "
        f"{native.library_path().name}")
    return name, smi


def phase_kernels(torch, kernels, zt, timer, data):
    """Each kernel against its plain version at the main-path shape."""
    n = 32768 + MAIN_CHUNK
    real = {}
    for level, fmt in KERNEL_RUNS:
        calls: dict = {}
        with capture(kernels, calls):  # two batches, as on the main path
            zt.compress(data, level=level, format=fmt, chunk_bytes=MAIN_CHUNK)
        for name, args in calls.items():
            real.setdefault(name, []).extend((level, a) for a in args)
    # The stream's first full chunk: one encode_segments call on (1, n).
    calls = {}
    with capture(kernels, calls):
        zt.zlib_compat.compressobj(6, wbits=31).compress(data[:MAIN_CHUNK])
    stream_real = {name: args for name, args in calls.items()}
    plain = {
        "scan_candidates": kernels.scan_candidates_plain,
        "propagate_matches": kernels.propagate_matches_plain,
        "parse_rows": kernels.parse_rows_plain,
    }
    seeded = seeded_inputs(torch, n, seed=1)
    results = {}
    for name in KERNELS:
        kfn = getattr(kernels, name)
        err = 0
        checked = 0
        for _, args in real[name]:
            if tuple(args[0].shape) != (BATCH, n):
                raise AssertionError(f"{name}: shape {tuple(args[0].shape)}")
        for args in stream_real[name]:
            if tuple(args[0].shape) != (1, n):
                raise AssertionError(
                    f"{name}: stream shape {tuple(args[0].shape)}")
        for args in (seeded[name] + [a for _, a in real[name]]
                     + stream_real[name]):
            e = max_abs_err(torch, kfn(*args), plain[name](*args))
            torch.cuda.synchronize()
            if e:
                raise AssertionError(f"{name}: kernel != plain (max err {e})")
            err = max(err, e)
            checked += 1
        per_launch = []
        if name in ("scan_candidates", "propagate_matches"):
            per_launch = [launch_line(timer, kernels, name, kfn, level, args)
                          for level, args in real[name]]
        per_launch += [launch_line(timer, kernels, name, kfn, "stream_L6", a)
                       for a in stream_real[name]]
        # Time on the last real L6 launch (for the scan: order B, K=16).
        level, args = [la for la in real[name] if la[0] == 6][-1]
        if name == "parse_rows":
            _, phases = kernels.parse_rows_phases(*args)
            split = timer.phases_ms(phases)
            log("  parse_rows phases: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in split.items()))
        ms = timer.kernel_ms(lambda: kfn(*args))
        plain_ms = timer.wall_ms(lambda: plain[name](*args))
        bound_ms, bound_by, extra = bound(kernels, name, args)
        library_ms = None
        if name == "propagate_matches":
            library_ms = propagate_library_ms(torch, timer, args[0])
        results[name] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        }
        if per_launch:
            results[name]["per_launch"] = per_launch
        log(f"kernel {name}: {checked} comparisons exact; shape "
            f"{tuple(args[0].shape)}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by})"
            + (f", library {library_ms:.4f} ms" if library_ms else "")
            + extra)
    results[OPTIMAL[0]] = optimal_report(torch, kernels, timer,
                                         real[OPTIMAL[0]], data, n)
    return results


def dp_walk(choice, start: int, end: int):
    """A row's DP choices ((n,) numpy, optimal_dp's) walked from start to
    end as the C DP walks its own: (committed, take, sel_len) as
    native.optimal_parse returns them."""
    import numpy as np

    ch = choice.tolist()
    pos = []
    i, end = int(start), int(end)
    while i < end:
        pos.append(i)
        i += ch[i] if ch[i] >= 3 else 1
    pos = np.asarray(pos, np.int64)
    com = np.zeros(len(ch), np.uint8)
    take = np.zeros_like(com)
    sel = np.zeros(len(ch), np.int32)
    com[pos] = 1
    m = pos[choice[pos] >= 3]
    take[m] = 1
    sel[m] = choice[m]
    return com, take, sel


def optimal_report(torch, kernels, timer, real, data, n: int) -> dict:
    """optimal_dp on the main path's launches: held to the C DP, timed
    beside its bytes bound, and the card's override beside the C path's
    on the first L9 batch (host clock)."""
    import types

    import numpy as np

    from zzflate_tpu_torch import encode_policy, native
    from zzflate_tpu_torch.config import LEVELS
    from zzflate_tpu_torch.encode_pipeline import build_chunk_batch
    from zzflate_tpu_torch.models import deflate_encoder as enc
    from zzflate_tpu_torch.ops import huffman_host

    name = OPTIMAL[0]
    levels = sorted({lv for lv, _ in real})
    if levels != list(OPT_LEVELS) or len(real) != 3 * MAIN_BATCHES:
        raise AssertionError(f"{name}: launches by level {levels}, "
                             f"{len(real)} in all")
    rows_checked = 0
    t0 = time.perf_counter()
    for level, args in real:
        if tuple(args[0].shape) != (BATCH, n):
            raise AssertionError(f"{name}: shape {tuple(args[0].shape)}")
        choice = kernels.optimal_dp(*args).cpu().numpy()
        d, ml, md, st, en, ln, bd = (a.cpu().numpy() for a in args)
        for j in range(BATCH):
            if choice[j, : max(st[j], 0)].any() or choice[j, en[j]:].any():
                raise AssertionError(f"{name} L{level} row {j}: a choice "
                                     "outside its range")
            got = dp_walk(choice[j], st[j], en[j])
            exp = native.optimal_parse(d[j], ml[j], md[j], st[j], en[j],
                                       ln[j, :, :288], ln[j, :, 288:], bd)
            for g, e, what in zip(got, exp, ("committed", "take",
                                             "sel_len")):
                if not np.array_equal(g, e):
                    raise AssertionError(
                        f"{name} L{level} row {j}: {what} != the C DP's")
            rows_checked += 1
    check_s = time.perf_counter() - t0
    per_level = []
    for level in OPT_LEVELS:
        args = [a for lv, a in real if lv == level][-1]
        ms = timer.kernel_ms(lambda: kernels.optimal_dp(*args))
        npos = (args[4] - args[3]).clamp(min=0)
        b_ms = int(npos.sum()) * OPT_BYTES_POS / HBM_BYTES_PER_S * 1e3
        ns_step = ms * 1e6 / int(npos.max())
        per_level.append({"level": level, "ms": ms, "bound_ms": b_ms,
                          "bound_by": "bytes", "share": b_ms / ms,
                          "ns_per_step": ns_step})
        log(f"  {name} L{level} {tuple(args[0].shape)}: {ms:.4f} ms, bound "
            f"{b_ms * 1e3:.2f} us (bytes), share {b_ms / ms:.4f}; "
            f"{ns_step:.1f} ns a step over {int(npos.max())} steps")

    # The main path's first L9 batch, analysed as the pipeline does.
    buf, vends, wstarts, nchunks = build_chunk_batch(
        data[: BATCH * MAIN_CHUNK], MAIN_CHUNK, None)
    starts = np.full(nchunks, 32768, np.int32)
    rows = [torch.as_tensor(a).cuda() for a in (buf, starts, vends, wstarts)]
    ana = enc.analyze_chunks_batch(*rows, LEVELS[9])
    freqs = ana["freqs"].cpu().numpy()
    host = {k: ana[k].cpu() for k in ("dcode", "mdist", "mm_packed")}
    ctx = types.SimpleNamespace(nchunks=nchunks + 1, fixed_only=False,
                                stream_final=True)

    def pass1():
        return [huffman_host.build_chunk_plan(
            freqs[j, :, :288], freqs[j, :, 288:], bfinal=0)
            for j in range(nchunks)]

    def card(plans):
        return encode_policy.optimal_override_card(ctx, plans, ana,
                                                   tuple(rows[:3]), 0)

    def c_dp(plans):
        return encode_policy.optimal_override(
            ctx, plans, host, host["mm_packed"].numpy(), buf, vends, 0)

    def wall_ms(fn):
        """Median host-clock ms of fn on fresh pass-1 plans (built
        outside the timed span), the card synced on both sides."""
        out = []
        for _ in range(OVERRIDE_REPS):
            plans = pass1()
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(plans)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return statistics.median(out), res, plans

    card_ms, (got, ntok), plans = wall_ms(card)
    c_ms, (exp, exp_ntok), exp_plans = wall_ms(c_dp)
    if ntok != exp_ntok:
        raise AssertionError(f"override L9: ntok {ntok} != {exp_ntok}")
    for k, e in exp.items():
        if not torch.equal(got[k].cpu(), e):
            raise AssertionError(f"override L9: {k} != the C DP path's")
    for p, e in zip(plans, exp_plans):
        for k in e:
            same = (p[k] == e[k] if k == "groups"
                    else np.array_equal(p[k], e[k]))
            if not same:
                raise AssertionError(f"override L9: plan {k} differs")
    log(f"kernel {name}: {rows_checked} rows of {len(real)} launches "
        f"(L7, L8, L9) equal to the C DP's parse ({check_s:.1f} s); L9 "
        f"batch override: card {card_ms:.2f} ms, C DP path {c_ms:.2f} ms "
        f"(host arrays; median of {OVERRIDE_REPS}), equal; {ntok} tokens "
        "in the longest row")
    last = per_level[-1]
    return {"rows_checked": rows_checked, "ms": last["ms"],
            "bound_ms": last["bound_ms"], "bound_by": "bytes",
            "per_level": per_level, "card_override_ms": card_ms,
            "c_override_ms": c_ms}


def launch_line(timer, kernels, name, kfn, level, args) -> dict:
    """Time, bound and share of one real launch, printed and returned."""
    t = timer.kernel_ms(lambda: kfn(*args))
    b_ms, b_by, _ = bound(kernels, name, args)
    line = {"level": level, "shape": list(args[0].shape)}
    at = f"L{level}" if isinstance(level, int) else level
    if name == "scan_candidates":
        line.update(k_each=args[3], lcp_cap=args[4],
                    backward_only=bool(args[5]))
        what = (f"scan {at} K={args[3]} cap={args[4]} "
                f"{'backward' if args[5] else 'both ways'}")
    else:
        what = f"{name} {at}"
    what += f" {tuple(args[0].shape)}"
    line.update(ms=t, bound_ms=b_ms, bound_by=b_by, share=b_ms / t)
    log(f"  {what}: {t:.4f} ms, bound {b_ms * 1e3:.2f} us ({b_by}), share "
        f"{b_ms / t:.3f}")
    return line


def bound(kernels, name, args):
    """Least time for the call's work: max(bytes / HBM rate, ops / rate).
    Bytes: every input read once, every output written once. Ops: the
    32-bit compare/select work this call's data needs."""
    if name == "scan_candidates":
        adj, spos, ws, k_each, _cap, backward_only = args
        elems = adj.numel()
        nbytes = elems * 16 + ws.numel() * 4
        # Per element and neighbour-direction the function needs 3
        # operations on the integer pipe: the running min of the LCPs, one
        # compare for the one-range validity test (lo <= cpos <= p0 - 1,
        # unsigned), and one max of the packed key (m << 15) + cpos into
        # the best. Its two adds (cpos - lo, and the key's) can issue on
        # the FMA pipe as IMAD, 64 lanes per SM of its own, so they take
        # no integer-pipe time and, at 2 per 3, never bound alone.
        ops = elems * k_each * (1 if backward_only else 2) * 3
        extra = f"; K={k_each} {'backward' if backward_only else 'both ways'}"
    elif name == "propagate_matches":
        elems = args[0].numel()
        nbytes = elems * 8
        # The sliding-window max needs about 3 maxima per element (the
        # prefix, the suffix, and their join), then the gate's compare and
        # the final max: 5 integer-pipe operations. The offsets (u = pk -
        # (E - m) * 2^15, and back) are adds that can issue on the FMA pipe
        # as IMAD, which has 64 lanes of its own. Bytes bound it: 8 B per
        # element against 5 operations.
        ops = elems * 5
        extra = ""
    else:
        step, starts, row = args
        elems = step.numel()
        nbytes = elems * 8 + starts.numel() * 4
        rows_per = step.shape[1] // row
        # P1 walks every position; P3 only the committed ones.
        mark = kernels.parse_rows(*args)
        committed = int(mark.sum().item())
        ops = (elems + committed) * 4 + step.shape[0] * rows_per * 4
        # 32-row segments, rows cut into 8 parts (csrc/parse.cu); the last
        # segment chains the maps of those between it and the start's.
        w = row // 8
        seg0 = max(int(starts.min()), 0) // row // 32
        chain = max(-(-rows_per // 32) - seg0 - 2, 0)
        extra = (f"; serial shared-memory steps: exits {w} + 8 + 32, marks "
                 f"up to {chain} + {w} + 8 + {w}; {committed} committed of "
                 f"{elems}")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), extra


def propagate_library_ms(torch, timer, pk):
    """Yardstick: one max_pool1d over the 512-wide window of
    float64(pk + i * 2^15), left-padded outside the timed call."""
    import torch.nn.functional as F

    i = torch.arange(pk.shape[1], device=pk.device, dtype=torch.float64)
    u = torch.where(pk > 0, pk.double() + i * 32768.0, 0.0)
    x = F.pad(u, (511, 0))[:, None, :].contiguous()
    return timer.kernel_ms(lambda: F.max_pool1d(x, 512, stride=1))


def phase_main(torch, kernels, zt, profiling, data):
    """compress() on the 8 MiB corpus: L6 gzip, L1 zlib and L9 gzip."""
    ref = {}
    for zl in (6, 9):
        t0 = time.perf_counter()
        ref[zl] = len(zlib.compress(data, zl))
        zlib_s = time.perf_counter() - t0
        log(f"zlib-{zl} (host, one thread): {ref[zl]} B in {zlib_s:.4f} s "
            f"({len(data) / 1e6 / zlib_s:.2f} MB/s)")
    counts, rates = {}, {}
    for level, fmt in MAIN_RUNS:
        def run():
            return zt.compress(data, level=level, format=fmt,
                               chunk_bytes=MAIN_CHUNK)

        run()  # warm-up: first-call allocations and kernel loads
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = run()
        secs = [time.perf_counter() - t0]
        launched = dict(kernels.launches)
        back = gzip.decompress(out) if fmt == "gzip" else zlib.decompress(out)
        if back != data:
            raise AssertionError(f"L{level} {fmt}: output does not decode")
        if zt.decompress(out, format=fmt) != data:
            raise AssertionError(f"L{level} {fmt}: zt.decompress differs")
        idle = [k for k in KERNELS if launched[k] == 0]
        if idle:
            raise AssertionError(f"L{level}: kernels never launched: {idle}")
        want = MAIN_BATCHES if level in OPT_LEVELS else 0
        if launched[OPTIMAL[0]] != want:
            raise AssertionError(f"L{level}: {OPTIMAL[0]} launched "
                                 f"{launched[OPTIMAL[0]]} times, not {want}")
        for _ in range(MAIN_REPS - 1):
            t0 = time.perf_counter()
            if run() != out:
                raise AssertionError(f"L{level}: output differs between runs")
            secs.append(time.perf_counter() - t0)
        dt = statistics.median(secs)
        log(f"main L{level} {fmt}: {len(data)} -> {len(out)} B; median "
            f"{dt:.4f} s of {MAIN_REPS} calls (min {min(secs):.4f}, max "
            f"{max(secs):.4f}) = {len(data) / 1e6 / dt:.3f} MB/s; size vs "
            f"zlib-6 {len(out) / ref[6]:.5f}, vs zlib-9 "
            f"{len(out) / ref[9]:.5f}; decodes with stdlib and "
            f"zt.decompress; launches {launched}")
        with profiling.collect() as st:
            run()
        log(f"stages L{level} ms (each stage synchronises the card): "
            + json.dumps({k: round(v, 3) for k, v in st.as_ms().items()}))
        trace(profiling, run, f"L{level}")
        counts[f"L{level}"] = launched
        rates[level] = len(data) / 1e6 / dt
    return counts, ref, rates


def trace(profiling, run, what: str) -> None:
    """One call under profiling.trace (its Chrome trace goes to
    chiprun_out/traces/): device time by kernel and the card's idle share
    of the call's wall time (kernels on one stream do not overlap)."""
    with profiling.trace(TRACE_DIR) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side events only: host ops also carry their kernels' time.
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    if not rows:
        log(f"trace {what}: no device time in the profile: not measured")
        return
    busy = sum(r[1] for r in rows)
    log(f"trace {what}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.4f}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {us / 1e3:9.3f} ms {count:6d}x {key[:90]}")


# Host runtime calls that put work on the card: a launch or an async copy
# or fill each.
RUNTIME_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")


def launch_calls(profiling, fn):
    """One call of fn under profiling.trace: its result and the work it
    put on the card, counted from the host's runtime calls. The profiler
    may return no device records for a window this short (seen on the
    H100 for a call of two kernels), so device time comes from events
    around the call (profiling.DeviceTimer.kernel_ms) instead."""
    import torch

    with profiling.trace(TRACE_DIR) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(e.count for e in prof.key_averages()
                    if e.key in RUNTIME_LAUNCHES)


def phase_stream(torch, kernels, zt, profiling, data, zlib6: int,
                 oneshot_mbps: float):
    """The 8 MiB corpus streamed through zlib_compat on the card."""
    def run():
        co = zt.zlib_compat.compressobj(6, wbits=31)
        out = bytearray()
        for off in range(0, len(data), STREAM_PIECE):
            out += co.compress(data[off : off + STREAM_PIECE])
        out += co.flush(zlib.Z_FINISH)
        return bytes(out)

    run()  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = run()
    secs = [time.perf_counter() - t0]
    launched = dict(kernels.launches)
    if gzip.decompress(out) != data:
        raise AssertionError("stream: output does not decode with gzip")
    idle = [k for k in KERNELS if launched[k] == 0]
    if idle:
        raise AssertionError(f"stream: kernels never launched: {idle}")
    for _ in range(STREAM_REPS - 1):
        t0 = time.perf_counter()
        if run() != out:
            raise AssertionError("stream: output differs between runs")
        secs.append(time.perf_counter() - t0)
    dt = statistics.median(secs)
    nchunks = -(-len(data) // MAIN_CHUNK)
    log(f"stream L6 gzip ({STREAM_PIECE} B pieces, {nchunks} chunks of "
        f"{MAIN_CHUNK}, one (1, {32768 + MAIN_CHUNK}) batch each): "
        f"{len(data)} -> {len(out)} B; median {dt:.4f} s of {STREAM_REPS} "
        f"calls (min {min(secs):.4f}, max {max(secs):.4f}) = "
        f"{len(data) / 1e6 / dt:.3f} MB/s against the one-shot L6 gzip's "
        f"{oneshot_mbps:.3f} MB/s; size vs zlib-6 {len(out) / zlib6:.5f}; "
        f"launches {launched}")
    with profiling.collect() as st:
        run()
    log("stages stream L6 ms (each stage synchronises the card): "
        + json.dumps({k: round(v, 3) for k, v in st.as_ms().items()}))
    trace(profiling, run, "stream L6")

    secs = []
    for _ in range(STREAM_REPS):
        d = zt.stream.Decompressor(format="gzip")
        back = bytearray()
        t0 = time.perf_counter()
        for off in range(0, len(out), STREAM_PIECE):
            back += d.decompress(out[off : off + STREAM_PIECE])
        back += d.flush()
        secs.append(time.perf_counter() - t0)
        if bytes(back) != data or not d.eof:
            raise AssertionError("stream: Decompressor does not give the input")
    dt = statistics.median(secs)
    log(f"host stream.Decompressor (C inflate on the host, not the card), "
        f"{STREAM_PIECE} B pieces: median {dt:.4f} s of {STREAM_REPS} = "
        f"{len(data) / 1e6 / dt:.3f} MB/s of output")

    buf = io.BytesIO()
    t0 = time.perf_counter()
    with zt.gzip_compat.GzipFile(fileobj=buf, mode="wb", compresslevel=6,
                                 mtime=0, engine="device") as f:
        for off in range(0, len(data), 1 << 20):
            f.write(data[off : off + (1 << 20)])
    dt = time.perf_counter() - t0
    if gzip.decompress(buf.getvalue()) != data:
        raise AssertionError("GzipFile on the card: output does not decode")
    log(f"gzip_compat.GzipFile(engine='device', level 6), 1 MiB writes: "
        f"{len(buf.getvalue())} B in {dt:.4f} s ({len(data) / 1e6 / dt:.3f} "
        f"MB/s, one call); decodes with stdlib gzip")
    return launched


def phase_reference(torch, zt, data, corpus):
    prefix = data[: 1 << 20]
    ref_in = corpus.mixed_corpus(REF_INPUT_BYTES, REF_INPUT_SEED)
    for level, want in ((6, REF_SHA256_L6_4K), (9, REF_SHA256_L9_4K)):
        gpu = zt.compress(prefix, level=level, format="gzip")
        cpu = zt.compress(prefix, level=level, format="gzip", device="cpu")
        if gpu != cpu:
            raise AssertionError(
                f"L{level} 1 MiB prefix: card bytes != CPU-path bytes")
        digest = hashlib.sha256(
            zt.compress(ref_in, level=level, chunk_bytes=4096)
        ).hexdigest()
        if digest != want:
            raise AssertionError(f"REF_SHA256_L{level}_4K mismatch: {digest}")
        log(f"reference L{level}: 1 MiB prefix card == CPU path ({len(gpu)} "
            f"B); 64 KiB L{level}/4K sha256 {digest} == REF_SHA256_L{level}_4K")
    gpu = stream_script(zt.stream.Compressor(level=6, format="gzip"), prefix,
                        STREAM_PIECE)
    cpu = stream_script(zt.stream.Compressor(level=6, format="gzip",
                                             device="cpu"),
                        prefix, STREAM_PIECE)
    if gpu != cpu:
        bad = [i for i, (a, b) in enumerate(zip(gpu, cpu)) if a != b]
        raise AssertionError(f"stream script: card != CPU path at calls {bad}")
    if gzip.decompress(b"".join(gpu)) != prefix:
        raise AssertionError("stream script: output does not decode")
    blob = b"".join(stream_script(
        zt.stream.Compressor(level=6, format="gzip", chunk_bytes=4096),
        ref_in, 4096))
    digest = hashlib.sha256(blob).hexdigest()
    if digest != REF_SHA256_STREAM_4K:
        raise AssertionError(f"REF_SHA256_STREAM_4K mismatch: {digest}")
    log(f"reference stream: 1 MiB prefix script card == CPU path on all "
        f"{len(gpu)} calls ({sum(map(len, gpu))} B); 64 KiB/4K script sha256 "
        f"{digest} == REF_SHA256_STREAM_4K")


# Integer operations of one token of the walk, counted from the step of
# csrc/walk.cu (its table path), each kind by the operations its result
# needs. A literal: the window's first word (1), the table lookup (2),
# the stop test (2), its code length and value (4), the emit (5: the
# value, the range test, atomicMax), the output and bit advance and the
# window's move (16: the offsets, the word delta and base, three word
# selects, the next word's load). A match adds the window's second word (1), the distance lookup
# and its test (7), the length's and distance's fields and extra bits
# (19), the longer advance (3) and a second word's load (3). The step is
# branch-free, so it issues the match's count for either kind.
WALK_OPS_LITERAL = 30
WALK_OPS_MATCH = 63


@contextlib.contextmanager
def walk_capture(kernels, calls: list):
    """Record every anchor_walk call's arguments (packed as it came in)
    while the body runs; the wrapper itself runs as it is."""
    orig = kernels.anchor_walk

    def rec(words, ll, d, lanes, packed, t_steps):
        calls.append((words, ll, d, lanes, packed.clone(), t_steps))
        return orig(words, ll, d, lanes, packed, t_steps)

    kernels.anchor_walk = rec
    try:
        yield
    finally:
        kernels.anchor_walk = orig


def walk_bound(args, after):
    """Least time of one walk launch: max(bytes / HBM rate, ops / integer
    rate), both from this run's data. Bytes: the group's body up to its
    last non-zero word (the zero padding past it is never decoded), the
    unit tables and the lanes read once, and each packed entry the launch
    changed read and written once (a token's atomicMax touches its own
    entry only). Ops: the tokens the launch decoded (the start marks it
    set), by kind."""
    words, ll, d, lanes, packed0, t_steps = args
    nz = (words != 0).nonzero()
    body_words = int(nz[-1].item()) + 1 if nz.numel() else 0
    changed = int((after != packed0).sum().item())
    nbytes = (body_words * 4 + changed * 8
              + sum(t.numel() * 4 for t in ll + d + lanes))
    new = ((after & 1) == 1) & ((packed0 & 1) == 0)
    matches = int((new & ((after >> 9) > 0)).sum().item())
    literals = int(new.sum().item()) - matches
    ops = literals * WALK_OPS_LITERAL + matches * WALK_OPS_MATCH
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops, "body_bytes": body_words * 4,
            "changed": changed,
            "lanes": int((lanes[3] != 0).sum().item()), "literals": literals,
            "matches": matches}


def hostile_walk_input(torch, idv, args, seed: int):
    """A real launch's tables plus idv._with_edge_units' two (the
    reserved litlen symbols 286 and 287, windows past the tree, the
    distance symbols 30 and 31), seeded words (half real code, half
    random: invalid windows), lanes at random bits, a tenth of them past
    the body's last word, a fifth past the output's end, some with a unit
    id out of range, some invalid."""
    words, ll, d, lanes, packed0, t_steps = args
    g = torch.Generator(device="cuda").manual_seed(seed)
    nw = words.shape[0]
    n = 4096
    npad = packed0.shape[0]
    ll, d = idv._with_edge_units(ll, d)
    u = ll[0].shape[0]

    def ri(lo, hi, k=n):
        return torch.randint(lo, hi, (k,), generator=g, device="cuda",
                             dtype=torch.int32)

    def coin(p):
        return torch.rand((n,), generator=g, device="cuda") < p

    w = torch.randint(-(1 << 31), 1 << 31, (nw,), generator=g, device="cuda",
                      dtype=torch.int64).int()
    w[: nw // 2] = words[: nw // 2]
    lanes = (torch.where(coin(0.1), ri(32 * nw - 40, 32 * nw + 4000),
                         ri(0, 32 * nw)).int(),
             torch.where(coin(0.2), ri(npad - 50, npad + 500),
                         ri(0, npad)).int(),
             torch.where(coin(0.5), ri(u - 2, u), ri(-2, u + 3)).int(),
             coin(0.9).int())
    return (w, ll, d, lanes, packed0, t_steps)


def walk_launch_report(torch, kernels, timer, args, label: str) -> dict:
    """One real walk launch: its time, bound and share; its lanes, blocks
    and the units a block spans; its first lane alone at t_steps and at about half of it
    (tokens and time), whose difference gives the time of one step and
    the chain floor t_steps x that."""
    words, ll, d, lanes, packed0, t_steps = args
    scratch = packed0.clone()
    ms = timer.kernel_ms(lambda: kernels.anchor_walk(
        words, ll, d, lanes, scratch, t_steps))
    after = kernels.anchor_walk(words, ll, d, lanes, packed0.clone(),
                                t_steps)
    b = walk_bound(args, after)
    live = (lanes[3] != 0).cpu().numpy()
    uid = lanes[2].cpu().numpy()
    wt = kernels.WALK_THREADS
    spans = [len(set(uid[i : i + wt][live[i : i + wt]].tolist()))
             for i in range(0, len(uid), wt)]
    spans = [x for x in spans if x]
    solo = {}
    one = tuple(t[:1] for t in lanes)
    for steps in (t_steps, t_steps // 2 + 1):
        out = packed0.clone()
        ms1 = timer.kernel_ms(lambda: kernels.anchor_walk(
            words, ll, d, one, out, steps))
        solo[steps] = (ms1, int((out != packed0).sum().item()))
    (full_ms, full_tok), (half_ms, half_tok) = solo.values()
    step_ns = ((full_ms - half_ms) / max(1, full_tok - half_tok) * 1e6)
    b.update(launch=label, ms=ms, share=b["bound_ms"] / ms,
             blocks=len(spans),
             units_per_block_max=max(spans),
             units_per_block_mean=sum(spans) / len(spans),
             t_steps=t_steps, one_lane_ms=full_ms, one_lane_tokens=full_tok,
             half_lane_ms=half_ms, half_lane_tokens=half_tok,
             step_ns=step_ns, chain_floor_ms=t_steps * step_ns * 1e-6)
    log(f"  anchor_walk {label}: {b['lanes']} lanes in {b['blocks']} blocks "
        f"of {wt}, units a block max {b['units_per_block_max']} mean "
        f"{b['units_per_block_mean']:.2f}; {b['literals']} literals + "
        f"{b['matches']} matches, t_steps {t_steps}: {ms:.4f} ms; bound "
        f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}; bytes "
        f"{b['bytes_ms'] * 1e3:.2f} us for {b['body_bytes']} B of body and "
        f"{b['changed']} packed entries, ops {b['ops_ms'] * 1e3:.2f} us), "
        f"share {b['share']:.4f}; first lane alone {full_ms:.4f} ms "
        f"({full_tok} tokens), at t_steps {t_steps // 2 + 1} {half_ms:.4f} ms "
        f"({half_tok} tokens): {step_ns:.1f} ns a step, chain floor "
        f"{b['chain_floor_ms']:.4f} ms = {b['chain_floor_ms'] / ms:.3f} of "
        f"the launch")
    return b


@contextlib.contextmanager
def recording(owner, name: str, calls: list):
    """Record the positional arguments of every call of owner.name while
    the body runs; the function itself runs as it is."""
    orig = getattr(owner, name)

    def rec(*a):
        calls.append(a)
        return orig(*a)

    setattr(owner, name, rec)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def commit_bound(kernels, args, mark) -> dict:
    """Least time of one commit_walk call: max(bytes / HBM rate, ops /
    integer rate). Bytes: the step read once as int32 (4 B a bit), the
    mark written once (1 B a bit), the starts and flags. Ops: per bit P1's
    and P2a's, per committed token P3's (COMMIT_OPS_*). The serial depth
    is the phases' dependent steps: 256 each for P1 (twice), P2a, P2c and
    P3, and the chain's max_sup_span."""
    step, start, valid, span = args
    nbits = step.numel()
    marks = int(mark.sum().item())
    nbytes = nbits * 5 + start.numel() * 5
    ops = nbits * COMMIT_OPS_BIT + marks * COMMIT_OPS_MARK
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops, "nbits": nbits,
            "units": int(valid.sum().item()), "max_sup_span": int(span),
            "marks": marks, "depth_steps": 5 * kernels.COMMIT_ROW + int(span)}


def commit_report(torch, kernels, profiling, timer, args, label) -> dict:
    """One real commit_walk call: the kernel against its plain version
    (exact), the kernel's device time on the int32 step (its three
    launches alone; L2 flushed, median of 15), the device launches of the
    call as the decode makes it (the int64 step's cast included) and of
    the plain version, the plain version's time, the bound and share."""
    step, start, valid, span = args
    got = kernels.commit_walk(*args)
    exp = kernels.commit_walk_plain(*args)
    err = max_abs_err(torch, got, exp)
    if err:
        raise AssertionError(f"commit_walk {label}: kernel != plain")
    s32 = step.to(torch.int32)
    ms = timer.kernel_ms(lambda: kernels.commit_walk(s32, start, valid, span))
    _, n_call = launch_calls(profiling, lambda: kernels.commit_walk(*args))
    _, n_plain = launch_calls(profiling,
                              lambda: kernels.commit_walk_plain(*args))
    plain_ms = timer.wall_ms(lambda: kernels.commit_walk_plain(*args), reps=1)
    b = commit_bound(kernels, args, got)
    b.update(launch=label, ms=ms, share=b["bound_ms"] / ms,
             plain_ms=plain_ms, launches_a_call=n_call,
             plain_launches_a_call=n_plain)
    log(f"  commit_walk {label}: {b['nbits']} bits, {b['units']} units, "
        f"max_sup_span {span}, {b['marks']} marks; kernel {ms:.4f} ms; bound "
        f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}; bytes "
        f"{b['bytes_ms'] * 1e3:.2f} us, ops {b['ops_ms'] * 1e3:.2f} us), "
        f"share {b['share']:.4f}; serial depth {b['depth_steps']} steps; "
        f"{n_call} device launches a call (runtime calls; the plain version "
        f"{n_plain}); plain {plain_ms:.3f} ms a call (events); equal")
    return b


def foreign_walk_calls(kernels, idv, blob: bytes, fmt: str, want: bytes):
    """Every anchor_walk call of one device decode of a foreign stream."""
    calls: list = []
    with walk_capture(kernels, calls):
        if idv.decompress_foreign(blob, format=fmt) != want:
            raise AssertionError("foreign decode: output differs")
    return calls


def phase_decode(torch, kernels, zt, profiling, timer, data, corpus):
    """Device decode of the 8 MiB corpus (indexed, zlib, gzip, raw), the
    64 MiB data-loading runs, the walk kernel against its plain version,
    the per-bit path (a v2 index, and the 64 MiB indexed run) with the
    commit kernel against its plain version, and the LZ tail's two
    kernels against theirs."""

    from zzflate_tpu_torch.models import inflate_device as idv
    from zzflate_tpu_torch.ops import checksums as cs
    from zzflate_tpu_torch.utils import containers
    from zzflate_tpu_torch.utils import lz_tail_bench as tail

    mb = len(data) / 1e6
    indexed = zt.compress(data, level=6, format="gzip",
                          chunk_bytes=MAIN_CHUNK, indexed=True)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    streams = {
        "indexed": ("gzip", indexed),
        "zlib": ("zlib", zlib.compress(data, 6)),
        "gzip": ("gzip", gzip.compress(data, 6, mtime=0)),
        "raw": ("raw", co.compress(data) + co.flush()),
    }
    counts, rates, cks_counts, commit_counts = {}, {}, {}, {}
    tail_counts = {}  # run -> launches of token_scatter and resolve_lz
    cand_counts = {}  # run -> launches of decode_candidates
    tail_names = (SCATTER[0], RESOLVE[0])
    for name, (fmt, blob) in streams.items():
        def run():
            return zt.decompress(blob, format=fmt, engine="device")

        run()  # warm-up: first-call allocations and table uploads
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = run()
        secs = [time.perf_counter() - t0]
        launched = kernels.launches["anchor_walk"]
        cks_counts[name] = {k: kernels.launches[k] for k in CHECKSUMS}
        commit_counts[name] = kernels.launches["commit_walk"]
        tail_counts[name] = {k: kernels.launches[k] for k in tail_names}
        cand_counts[name] = kernels.launches[CAND[0]]
        if out != data:
            raise AssertionError(f"decode {name}: output differs from input")
        if tail_counts[name] != {SCATTER[0]: 0, RESOLVE[0]: launched}:
            raise AssertionError(f"decode {name}: LZ tail launches "
                                 f"{tail_counts[name]}, walk {launched}")
        if commit_counts[name] or cand_counts[name]:
            raise AssertionError(f"decode {name}: commit_walk or "
                                 "decode_candidates launched on the walk "
                                 "path")
        if launched == 0:
            raise AssertionError(f"decode {name}: anchor_walk never launched")
        if fmt == "gzip" and cks_counts[name]["crc32_rows"] == 0:
            raise AssertionError(f"decode {name}: crc32_rows never launched")
        for _ in range(DECODE_REPS - 1):
            t0 = time.perf_counter()
            if run() != data:
                raise AssertionError(f"decode {name}: output differs")
            secs.append(time.perf_counter() - t0)
        host = []
        for _ in range(DECODE_REPS):
            t0 = time.perf_counter()
            if zt.decompress(blob, format=fmt) != data:
                raise AssertionError(f"host decode {name}: output differs")
            host.append(time.perf_counter() - t0)
        dt, ht = statistics.median(secs), statistics.median(host)
        log(f"decode {name} ({fmt}): {len(blob)} -> {len(data)} B; device "
            f"median {dt:.4f} s of {DECODE_REPS} (min {min(secs):.4f}, max "
            f"{max(secs):.4f}) = {mb / dt:.3f} MB/s of output; host C decoder "
            f"median {ht:.4f} s = {mb / ht:.3f} MB/s; anchor_walk launches "
            f"{launched}; checksum kernel launches {cks_counts[name]}; LZ "
            f"tail kernel launches {tail_counts[name]}")
        with profiling.collect() as st:
            run()
        log(f"stages decode {name} ms (each device stage synchronises the "
            "card): " + json.dumps({k: round(v, 3)
                                    for k, v in st.as_ms().items()}))
        counts[name] = launched
        rates[name] = (mb / dt, mb / ht)
    trace(profiling, lambda: zt.decompress(indexed, format="gzip",
                                           engine="device"), "decode indexed")

    # Every group's LZ resolve of the four runs, against its plain version;
    # the rounds are read from the card after each call.
    resolve_groups, rounds, tail_err = {}, {}, 0
    for name, (fmt, blob) in streams.items():
        calls: dict = {}
        undo = tail.recorder(kernels, calls)
        try:
            zt.decompress(blob, format=fmt, engine="device")
        finally:
            undo()
        resolve_groups[name] = calls[RESOLVE[0]]
        rounds[name] = []
        for a in calls[RESOLVE[0]]:
            e, r, _ = tail.check_resolve(kernels, a)
            tail_err = max(tail_err, e)
            rounds[name].append(r)
    if tail_err:
        raise AssertionError("resolve_lz: kernel != plain on an 8 MiB group")
    log(f"LZ resolve doubling rounds per group (the kernel's, read from the "
        f"card; equal to the plain version's, bytes and parents equal): "
        f"{rounds}")

    # Every group CRC of one indexed and one gzip decode, for phase 8.
    crc_groups = []
    orig_crc = cs._crc32_impl
    for name in ("indexed", "gzip"):
        fmt, blob = streams[name]

        def rec_crc(buf, length, start=0, name=name):
            k = sum(g[0].startswith(name) for g in crc_groups)
            crc_groups.append((f"{name} group {k}", buf, int(length),
                               int(start)))
            return orig_crc(buf, length, start)

        cs._crc32_impl = rec_crc
        try:
            zt.decompress(blob, format=fmt, engine="device")
        finally:
            cs._crc32_impl = orig_crc

    buf = torch.randint(0, 256, (1 << 22,), dtype=torch.uint8, device="cuda")
    n_crc = (1 << 22) - 12345
    cs._crc32_impl(buf, n_crc, idv._W)  # warm-up: the tables' upload
    torch.cuda.synchronize()
    kernels.reset_launches()
    crc, n_ev = launch_calls(
        profiling, lambda: cs._crc32_impl(buf, n_crc, idv._W))
    calls = kernels.launches["crc32_rows"]
    want = zlib.crc32(buf[idv._W : n_crc].cpu().numpy().tobytes())
    if int(crc) != want:
        raise AssertionError("device crc32 != zlib.crc32")
    if calls != 1 or n_ev > 3:
        raise AssertionError(f"4 MiB group CRC: {calls} crc32_rows calls, "
                             f"{n_ev} device launches")
    ev_ms = timer.kernel_ms(lambda: cs._crc32_impl(buf, n_crc, idv._W))
    crc_ms = timer.wall_ms(lambda: cs._crc32_impl(buf, n_crc, idv._W))
    crc_line = {"launches": n_ev, "device_ms": ev_ms, "call_ms": crc_ms}
    log(f"CRC-32 of a 4 MiB group on the card: {n_ev} launches (runtime "
        f"calls; {calls} crc32_rows call), {ev_ms:.4f} ms device time "
        f"(events, L2 flushed, median of 15), {crc_ms:.4f} ms a call "
        "(events); equals zlib.crc32")

    bad = bytearray(indexed)
    bad[len(bad) // 2] ^= 0x40  # a payload byte
    kernels.reset_launches()
    try:
        idv.decompress_indexed(bytes(bad))
    except ValueError as e:
        msg = str(e)
    else:
        raise AssertionError("a flipped payload byte decoded without error")
    if kernels.launches["anchor_walk"] == 0:
        raise AssertionError("flipped byte: the walk never ran on the card")
    log(f"flipped payload byte: ValueError on the card ({msg})")

    t0 = time.perf_counter()
    big = corpus.mixed_corpus(DECODE_BIG, seed=1)
    big_idx = zt.compress(big, level=6, format="gzip",
                          chunk_bytes=MAIN_CHUNK, indexed=True)
    big_gz = gzip.compress(big, 6, mtime=0)
    setup_s = time.perf_counter() - t0
    # At 64 MiB the anchors (~8 B per 1 024 tokens) no longer fit the
    # 64 KiB FEXTRA, so the encoder writes the index without them (as the
    # reference's does) and the indexed stream decodes on the per-bit
    # path; the stdlib gzip of the same bytes takes the walk.
    if containers.parse_gzip_index(big_idx)[2] != 0:
        raise AssertionError("64 MiB index carries anchors: expected none")
    want_t = torch.frombuffer(bytearray(big), dtype=torch.uint8).cuda()
    big_mb = len(big) / 1e6
    big_commit = []  # the per-bit run's first and last groups' arguments
    big_tail: dict = {}  # run -> its first and last LZ tail calls
    for name, blob, walk in (("indexed, per-bit path", big_idx, False),
                             ("stdlib gzip, anchor walk", big_gz, True)):
        def run_big():
            if walk:
                arr, n = idv.decompress_foreign(blob, format="gzip",
                                                to_device=True)
            else:
                arr, n = idv.decompress_indexed(blob, to_device=True)
            torch.cuda.synchronize()
            return arr, n

        key = f"64 MiB {name}, to_device"
        groups: list = []
        big_tail[key] = {}
        undo = tail.recorder(kernels, big_tail[key], ends=True)
        try:
            with recording(idv, "_commit_walk", groups):
                run_big()  # warm-up, recording every group's commit
                # arguments and the first and last LZ tail calls
        finally:
            undo()
        if groups:
            big_commit = [groups[0], groups[-1]]
        commit_groups = len(groups)
        del groups
        kernels.reset_launches()
        secs = []
        for k in range(DECODE_REPS):
            t0 = time.perf_counter()
            arr, n = run_big()
            secs.append(time.perf_counter() - t0)
            if k == 0:
                counts[key] = kernels.launches["anchor_walk"]
                cks_counts[key] = {c: kernels.launches[c] for c in CHECKSUMS}
                commit_counts[key] = kernels.launches["commit_walk"]
                cand_counts[key] = kernels.launches[CAND[0]]
                tail_counts[key] = {c: kernels.launches[c]
                                    for c in tail_names}
            if (not arr.is_cuda or n != len(big)
                    or not torch.equal(arr, want_t)):
                raise AssertionError(f"{key}: tensor differs from input")
            del arr
        if (counts[key] > 0) != walk:
            raise AssertionError(f"{key}: anchor_walk launches {counts[key]}")
        if cks_counts[key]["crc32_rows"] == 0:
            raise AssertionError(f"{key}: crc32_rows never launched")
        if (commit_counts[key] != (0 if walk else commit_groups)
                or cand_counts[key] != commit_counts[key]):
            raise AssertionError(f"{key}: commit_walk launches "
                                 f"{commit_counts[key]}, decode_candidates "
                                 f"{cand_counts[key]}, groups "
                                 f"{commit_groups}")
        n_groups = counts[key] if walk else commit_groups
        if tail_counts[key] != {SCATTER[0]: 0 if walk else n_groups,
                                RESOLVE[0]: n_groups}:
            raise AssertionError(f"{key}: LZ tail launches "
                                 f"{tail_counts[key]}, groups {n_groups}")
        t0 = time.perf_counter()
        if zt.decompress(blob, format="gzip") != big:
            raise AssertionError(f"{key}: host decode differs")
        host_s = time.perf_counter() - t0
        dt = statistics.median(secs)
        log(f"decode {key}=True: {len(blob)} -> {len(big)} B; median "
            f"{dt:.4f} s of {len(secs)} call(s) (min {min(secs):.4f}, max "
            f"{max(secs):.4f}) = {big_mb / dt:.3f} MB/s; a CUDA tensor equal "
            f"to the input; anchor_walk launches {counts[key]}; commit_walk "
            f"launches {commit_counts[key]}; decode_candidates launches "
            f"{cand_counts[key]}; LZ tail kernel launches "
            f"{tail_counts[key]}; checksum "
            f"kernel launches {cks_counts[key]}; host C "
            f"decoder to bytes {host_s:.4f} s = {big_mb / host_s:.3f} MB/s")
        rates[key] = (big_mb / dt, big_mb / host_s)
        with profiling.collect() as st:
            run_big()
        log(f"stages decode {key} ms: " + json.dumps(
            {k: round(v, 3) for k, v in st.as_ms().items()}))
    log(f"64 MiB corpus, card L6 indexed encode and stdlib gzip: "
        f"{setup_s:.2f} s")
    del want_t

    calls: list = []
    with walk_capture(kernels, calls):
        zt.decompress(indexed, format="gzip", engine="device")
    fmt, gz = streams["gzip"]
    fcalls = foreign_walk_calls(kernels, idv, gz, fmt, data)
    if fcalls[0][5] != idv.FOREIGN_ANCHOR_TOKENS + 2:
        raise AssertionError("foreign walk: t_steps is not the spacing + 2")
    checked, walk_err, plain_ms = 0, 0, None
    for args in (calls[0], fcalls[0],
                 hostile_walk_input(torch, idv, calls[0], seed=3),
                 hostile_walk_input(torch, idv, fcalls[0], seed=4)):
        words, ll, d, lanes, packed0, t_steps = args
        got = kernels.anchor_walk(words, ll, d, lanes, packed0.clone(),
                                  t_steps)
        # The plain walk runs once per input; its time is taken on the
        # first group's (events: its host gaps are part of its cost).
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        exp = kernels.anchor_walk_plain(words, ll, d, lanes, packed0.clone(),
                                        t_steps)
        ev[1].record()
        torch.cuda.synchronize()
        if plain_ms is None:
            plain_ms = ev[0].elapsed_time(ev[1])
        walk_err = max(walk_err, max_abs_err(torch, got, exp))
        checked += 1
    if walk_err:
        raise AssertionError(f"anchor_walk: kernel != plain (err {walk_err})")
    per_launch = [walk_launch_report(torch, kernels, timer, args,
                                     f"indexed group {k}")
                  for k, args in enumerate(calls)]
    foreign_launch = [walk_launch_report(torch, kernels, timer, args,
                                         f"gzip group {k}")
                      for k, args in enumerate(fcalls)]
    first = per_launch[0]
    log(f"kernel anchor_walk: {checked} comparisons (indexed and gzip first "
        f"groups, two hostile inputs), max abs err {walk_err}; first indexed "
        f"group kernel {first['ms']:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{first['bound_ms'] * 1e3:.2f} us ({first['bound_by']}), first lane "
        f"alone {first['one_lane_ms']:.4f} ms; each block of "
        f"{kernels.WALK_THREADS} lanes asks {kernels.WALK_SMEM_BYTES} B of "
        f"dynamic shared memory (csrc/kernels.h); library: none")

    pre = data[:V2_BYTES]
    v2 = tail.to_v2(zt.compress(pre, level=6, format="gzip",
                                chunk_bytes=MAIN_CHUNK, indexed=True),
                    containers)
    v2_commit, v2_all, v2_tail = [], [], {}
    undo = tail.recorder(kernels, v2_tail, ends=True)
    try:
        with recording(idv, "_commit_walk", v2_commit), \
                recording(idv, "_decode_all", v2_all):
            idv.decompress_indexed(v2)  # warm-up, recording every group
    finally:
        undo()
    kernels.reset_launches()
    secs = []
    for k in range(DECODE_REPS):
        t0 = time.perf_counter()
        if idv.decompress_indexed(v2) != pre:
            raise AssertionError("v2 index: device decode differs")
        secs.append(time.perf_counter() - t0)
        if k == 0:
            commit_counts["v2 1 MiB"] = kernels.launches["commit_walk"]
            cand_counts["v2 1 MiB"] = kernels.launches[CAND[0]]
            tail_counts["v2 1 MiB"] = {c: kernels.launches[c]
                                       for c in tail_names}
            if kernels.launches["anchor_walk"]:
                raise AssertionError("v2 index: the walk ran (per-bit path "
                                     "expected)")
    if not (commit_counts["v2 1 MiB"] == cand_counts["v2 1 MiB"]
            == len(v2_commit)):
        raise AssertionError(f"v2 index: commit_walk launches "
                             f"{commit_counts['v2 1 MiB']}, "
                             f"decode_candidates {cand_counts['v2 1 MiB']}, "
                             f"groups {len(v2_commit)}")
    if set(tail_counts["v2 1 MiB"].values()) != {len(v2_commit)}:
        raise AssertionError(f"v2 index: LZ tail launches "
                             f"{tail_counts['v2 1 MiB']}, groups "
                             f"{len(v2_commit)}")
    host = []
    for _ in range(DECODE_REPS):
        t0 = time.perf_counter()
        if zt.decompress(v2, format="gzip") != pre:
            raise AssertionError("v2 index: host decode differs")
        host.append(time.perf_counter() - t0)
    v2_mb = len(pre) / 1e6
    v2_s, v2_host = statistics.median(secs), statistics.median(host)
    rates["v2 1 MiB"] = (v2_mb / v2_s, v2_mb / v2_host)
    with profiling.collect() as st:
        idv.decompress_indexed(v2)
    split = tail.device_split(torch, lambda: idv._decode_all(*v2_all[0]),
                              TRACE_DIR, log=log)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        idv._decode_all(*v2_all[0])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    split["wall_ms"] = statistics.median(walls) * 1e3
    stages = tail.stage_split(torch, idv, kernels, v2_all[0])
    if split["device_ms"] is None or stages["device_ms"] is None:
        raise AssertionError("v2 _decode_all: the profile holds no device "
                             "records, so its launches cannot be checked")
    log("v2 group 0's _decode_all by stage (one profiled call, each stage "
        "in a range of its own): " + json.dumps(stages) + f"; the stages' "
        f"{stages['launches']} device launches against the whole call's "
        f"{split['launches']}")
    if (split["launches"] > DECODE_ALL_MAX_LAUNCHES
            or split["candidates_launches"] != 2):
        raise AssertionError(f"v2 _decode_all: {split['launches']} device "
                             f"launches, candidate kernels "
                             f"{split['candidates_launches']}")
    # No host sync: the per-bit group, and the walk path's resolve.
    tail.no_sync(torch, lambda: idv._decode_all(*v2_all[0]))
    tail.no_sync(torch, lambda: idv._resolve_lz(
        *resolve_groups["indexed"][0],
        resolve_groups["indexed"][0][0].shape[0]))
    rest = (f"{split['launches']} device launches, "
            f"{split['device_ms']:.3f} ms device time, of which the candidate "
            f"kernels {split['candidates_ms']:.3f} ms "
            f"({split['candidates_launches']} launches), the commit "
            f"kernels {split['commit_ms']:.3f} ms ({split['commit_launches']} "
            f"launches), token_scatter {split['scatter_ms']:.3f} ms "
            f"({split['scatter_launches']}), resolve_lz's "
            f"{split['resolve_ms']:.3f} ms ({split['resolve_launches']}) and "
            f"the rest {split['rest_ms']:.3f} ms")
    rest += (f"; wall {split['wall_ms']:.3f} ms a call (median of 3); no "
             "host sync (set_sync_debug_mode error), nor in the walk "
             "path's resolve")
    log(f"v2 index (per-bit path), {len(pre)} B in {len(v2_commit)} "
        f"group(s): device median {v2_s:.4f} s of {DECODE_REPS} (min "
        f"{min(secs):.4f}, max {max(secs):.4f}) = {v2_mb / v2_s:.3f} MB/s; "
        f"host C decoder {v2_host:.4f} s = {v2_mb / v2_host:.3f} MB/s; "
        f"commit_walk launches {commit_counts['v2 1 MiB']}; stages ms "
        + json.dumps({k: round(v, 3) for k, v in st.as_ms().items()})
        + f"; _decode_all of its first group: {rest}")
    del v2_all

    # The commit kernel against its plain version: seeded cases first
    # (corpus.commit_walk_inputs, at the tests' sizes and a group's), then
    # every v2 group and the 64 MiB per-bit run's first and last, each
    # also timed.
    synth, err = 0, 0
    for case in corpus.COMMIT_CASES:
        for nbits in (2 << 16, 4 << 16, idv._GROUP_BITS):
            step, start, valid, span = corpus.commit_walk_inputs(case, nbits)
            args = (torch.from_numpy(step).cuda(),
                    torch.from_numpy(start).cuda(),
                    torch.from_numpy(valid).cuda(), span)
            err = max(err, max_abs_err(torch, kernels.commit_walk(*args),
                                       kernels.commit_walk_plain(*args)))
            synth += 1
    if err:
        raise AssertionError(f"commit_walk: kernel != plain on the seeded "
                             f"cases (err {err})")
    one = (torch.full((1 << 16,), 8, dtype=torch.int32, device="cuda"),
           torch.zeros((1,), dtype=torch.int32, device="cuda"),
           torch.ones((1,), dtype=torch.bool, device="cuda"), 1)
    floor_ms = timer.kernel_ms(lambda: kernels.commit_walk(*one))
    log(f"kernel commit_walk: exact on {synth} seeded inputs "
        f"({len(corpus.COMMIT_CASES)} cases x 3 sizes); one superrow with "
        f"one unit (its serial depth alone, one block a launch) "
        f"{floor_ms:.4f} ms; each block of the two superrow launches asks "
        f"132 096 B of dynamic shared memory (csrc/kernels.h)")
    commit_reports = [
        commit_report(torch, kernels, profiling, timer, a, f"v2 group {k}")
        for k, a in enumerate(v2_commit)]
    commit_reports += [
        commit_report(torch, kernels, profiling, timer, a,
                      f"64 MiB per-bit group {k}")
        for k, a in zip(("first", "last"), big_commit)]
    del v2_commit, big_commit
    big_key = "64 MiB indexed, per-bit path, to_device"

    # The candidate kernel against its plain version: the seeded cases of
    # corpus.candidate_inputs at CAND_SIZES, then the v2 group and the 64
    # MiB per-bit run's first and last, each also timed.
    seeded_cand = tail.candidate_checks(torch, kernels, corpus, CAND_SIZES)
    if seeded_cand["max_abs_err"]:
        raise AssertionError("decode_candidates: kernel != plain on a "
                             "seeded case")
    log(f"kernel decode_candidates: exact on {seeded_cand['inputs']} seeded "
        f"inputs ({len(corpus.CANDIDATE_CASES)} cases x {len(CAND_SIZES)} "
        f"sizes, U = 1 to 1 024)")
    cand_reports = [tail.candidates_report(
        kernels, timer, v2_tail[CAND[0]][0], "v2 group 0", log=log)]
    cand_reports += [
        tail.candidates_report(kernels, timer, a, f"64 MiB per-bit {end} "
                               "group", log=log)
        for a, end in zip(big_tail[big_key][CAND[0]], ("first", "last"))]
    mc = cand_reports[1]  # the 64 MiB per-bit run's first group
    cand = {"launches": cand_counts[big_key], "launches_by_run": cand_counts,
            "max_abs_err": 0, **{k: mc[k] for k in ("ms", "plain_ms",
                                                     "bound_ms", "bound_by",
                                                     "share")},
            "library_ms": None, "seeded_inputs": seeded_cand["inputs"],
            "per_launch": cand_reports,
            "decode_all_v2_group": {"whole": split, "by_stage": stages}}
    main = commit_reports[-2]  # the 64 MiB per-bit run's first group
    commit = {"launches": commit_counts[big_key],
              "launches_by_run": commit_counts, "max_abs_err": err,
              "ms": main["ms"], "plain_ms": main["plain_ms"],
              "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
              "library_ms": None, "one_superrow_ms": floor_ms,
              "seeded_inputs": synth, "per_launch": commit_reports,
              "MBps_device_vs_host": {
                  k: rates[k] for k in ("v2 1 MiB", "64 MiB indexed, "
                                        "per-bit path, to_device")}}
    walk = {"launches": counts["indexed"], "launches_by_run": counts,
            "max_abs_err": walk_err, "ms": first["ms"], "plain_ms": plain_ms,
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None,
            "per_launch": per_launch, "foreign_per_launch": foreign_launch,
            "foreign_spacing": idv.FOREIGN_ANCHOR_TOKENS,
            "MBps_device_vs_host": rates}
    scatter, resolve = lz_tail_phase(torch, kernels, corpus, tail, timer,
                                     v2_tail, big_tail, resolve_groups)
    scatter.update(launches=tail_counts[big_key][SCATTER[0]],
                   launches_by_run={k: c[SCATTER[0]]
                                    for k, c in tail_counts.items()},
                   decode_all_v2_group=split)
    resolve.update(launches=tail_counts["indexed"][RESOLVE[0]],
                   launches_by_run={k: c[RESOLVE[0]]
                                    for k, c in tail_counts.items()},
                   rounds_8mib_groups=rounds)
    return walk, {"launches_by_run": cks_counts, "groups": crc_groups,
                  "crc_4mib_group": crc_line}, commit, cand, scatter, resolve


def lz_tail_phase(torch, kernels, corpus, tail, timer, v2_tail, big_tail,
                  resolve_groups):
    """The LZ tail's kernels against their plain versions on the seeded
    cases at a group's size, then on the real groups, each timed (with
    the bound, the plain version, and for token_scatter the torch scatters
    it replaced). Returns the kernels JSON entries of token_scatter and
    resolve_lz (launches added by the caller)."""
    seeded = tail.seeded_checks(torch, kernels, corpus)
    if seeded["max_abs_err"]:
        raise AssertionError("LZ tail: kernel != plain on a seeded case")
    log(f"LZ tail kernels: exact on {seeded['cases']} seeded cases at "
        f"{tail.GROUP} positions and bits (corpus.RESOLVE_CASES, "
        f"SCATTER_CASES); their doubling rounds {seeded['rounds']}")
    groups = [("v2 group 0", {k: c[0] for k, c in v2_tail.items()})]
    groups += [(f"{run}, {end} group", {k: c[i] for k, c in calls.items()})
               for run, calls in big_tail.items()
               for i, end in enumerate(("first", "last"))]
    groups += [(f"indexed group {k}", {RESOLVE[0]: a})
               for k, a in enumerate(resolve_groups["indexed"])]
    groups += [(f"{name} group 0", {RESOLVE[0]: resolve_groups[name][0]})
               for name in ("zlib", "gzip", "raw")]
    reports = []
    for label, calls in groups:
        reports.append(tail.tail_report(
            torch, kernels, timer, label, calls.get(SCATTER[0]),
            calls[RESOLVE[0]], log=log))
    per_scatter = [dict(r[SCATTER[0]], group=r["group"]) for r in reports
                   if SCATTER[0] in r]
    per_resolve = [dict(r[RESOLVE[0]], group=r["group"]) for r in reports]
    # The per-bit path's 64 MiB run's first group, and the walk path's
    # first indexed group, stand for each kernel in the kernels line.
    ms = next(r for r in per_scatter if r["group"].startswith("64 MiB"))
    mr = next(r for r in per_resolve if r["group"] == "indexed group 0")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    scatter = {"max_abs_err": 0, **{k: ms[k] for k in keys},
               "library_ms": ms["library_ms"],
               "library": "three torch scatter_reduce_(\"amax\") calls over "
                          "every bit, the dropped ones at a trash slot",
               "seeded_cases": len(corpus.SCATTER_CASES),
               "per_launch": per_scatter}
    resolve = {"max_abs_err": 0, **{k: mr[k] for k in keys},
               "library_ms": None, "seeded_cases": len(corpus.RESOLVE_CASES),
               "seeded_rounds": seeded["rounds"], "per_launch": per_resolve}
    return scatter, resolve


def trailer_crc(blob: bytes) -> int:
    return int.from_bytes(blob[-8:-4], "little")


def phase_parallel(torch, kernels, zt, profiling, timer, corpus):
    """compress_sharded on two layouts, the dryrun_multichip cases, the
    partials' device cost, and compress_multihost in 2 and 3 processes."""
    import numpy as np

    from zzflate_tpu_torch.config import CodecConfig
    from zzflate_tpu_torch.encode_pipeline import (
        build_chunk_batch,
        encode_segments,
    )
    from zzflate_tpu_torch.ops import checksums as cs
    from zzflate_tpu_torch.parallel import compress_sharded, make_mesh

    t0 = time.perf_counter()
    data = corpus.mixed_corpus(PAR_BYTES, seed=2)
    mb = len(data) / 1e6
    want_crc = zlib.crc32(data)
    log(f"parallel corpus: {len(data)} B in {time.perf_counter() - t0:.2f} s")

    def one_card():
        return zt.compress(data, level=6, format="gzip",
                           chunk_bytes=MAIN_CHUNK)

    single = one_card()  # warm-up, and the bytes every layout must give
    secs = []
    for _ in range(PAR_REPS):
        t0 = time.perf_counter()
        if one_card() != single:
            raise AssertionError("one card: output differs between runs")
        secs.append(time.perf_counter() - t0)
    one_mbps = mb / statistics.median(secs)
    if gzip.decompress(single) != data:
        raise AssertionError("one card 64 MiB: output does not decode")
    log(f"parallel one card, compress(): {len(data)} -> {len(single)} B; "
        f"median {statistics.median(secs):.4f} s of {PAR_REPS} = "
        f"{one_mbps:.3f} MB/s")

    counts, rates = {}, {"one card": one_mbps}
    cuda0 = torch.device("cuda", 0)
    layouts = {"make_mesh": make_mesh(), "cuda:0 twice": [cuda0, cuda0]}
    for name, mesh in layouts.items():
        def run():
            return compress_sharded(data, level=6, format="gzip", mesh=mesh,
                                    chunk_bytes=MAIN_CHUNK)

        run()  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = run()
        secs = [time.perf_counter() - t0]
        launched = dict(kernels.launches)
        if out != single:
            raise AssertionError(f"sharded {name}: bytes != one card's")
        if gzip.decompress(out) != data:
            raise AssertionError(f"sharded {name}: output does not decode")
        if trailer_crc(out) != want_crc:
            raise AssertionError(f"sharded {name}: trailer CRC != zlib.crc32")
        idle = [k for k in (*KERNELS, *CHECKSUMS) if launched[k] == 0]
        if idle:
            raise AssertionError(f"sharded {name}: never launched: {idle}")
        for _ in range(PAR_REPS - 1):
            t0 = time.perf_counter()
            if run() != single:
                raise AssertionError(f"sharded {name}: output differs")
            secs.append(time.perf_counter() - t0)
        dt = statistics.median(secs)
        log(f"sharded {name} ({[str(d) for d in mesh]}): {len(data)} -> "
            f"{len(out)} B == one card's; trailer CRC {trailer_crc(out):#010x}"
            f" (card partials) == zlib.crc32; median {dt:.4f} s of "
            f"{PAR_REPS} (min {min(secs):.4f}, max {max(secs):.4f}) = "
            f"{mb / dt:.3f} MB/s against one card's {one_mbps:.3f}; launches "
            f"{launched}")
        with profiling.collect() as st:
            run()
        log(f"stages sharded {name} ms (each stage synchronises every card "
            "of the mesh; analyze includes the partials): "
            + json.dumps({k: round(v, 3) for k, v in st.as_ms().items()}))
        if name == "make_mesh":
            trace(profiling, run, f"sharded {name}")
        counts[f"sharded {name}"] = launched
        rates[f"sharded {name}"] = mb / dt

    # The partials alone on one batch: (16, 294912) rows of the corpus.
    buf, vends, _, nch = build_chunk_batch(data[: BATCH * MAIN_CHUNK],
                                           MAIN_CHUNK, None)
    rows = torch.as_tensor(buf).cuda()
    ends = torch.as_tensor(vends).cuda()
    starts = torch.full((nch,), 32768, dtype=torch.int32, device="cuda")

    def partials():
        return cs.adler32_rows(rows, ends, starts), cs.crc32_rows(
            rows, ends, starts)

    partials()  # warm-up: the tables' upload
    torch.cuda.synchronize()
    kernels.reset_launches()
    (adler, crc), n_ev = launch_calls(profiling, partials)
    calls = {k: kernels.launches[k] for k in CHECKSUMS}
    if n_ev > 6 or any(v != 1 for v in calls.values()):
        raise AssertionError(
            f"partials: {n_ev} device launches, calls {calls}")
    for j in range(nch):
        chunk = data[j * MAIN_CHUNK : (j + 1) * MAIN_CHUNK]
        if (int(adler[j]), int(crc[j])) != (zlib.adler32(chunk),
                                            zlib.crc32(chunk)):
            raise AssertionError(f"partials of chunk {j} != zlib's")
    ev_ms = timer.kernel_ms(partials)
    part_ms = timer.wall_ms(partials)
    part = {"launches": n_ev, "device_ms": ev_ms, "call_ms": part_ms,
            "kernel_calls": calls}
    log(f"partials of one batch {tuple(rows.shape)} (adler32_rows + "
        f"crc32_rows): {n_ev} launches (runtime calls; {calls}), "
        f"{ev_ms:.4f} ms device time (events, L2 flushed, median of 15), "
        f"{part_ms:.4f} ms a call (events); equal zlib's on every chunk")

    # __graft_entry__.dryrun_multichip(8)'s cases, the card named 8 times.
    rng = np.random.default_rng(7)
    unit = b"a tiny but repetitive dry-run corpus "
    text = (unit * (MAIN_CHUNK * 6 // len(unit) + 1))[: MAIN_CHUNK * 6]
    tail = (b"uneven tail " * 5000)[: MAIN_CHUNK // 3]
    dry = (text + rng.integers(0, 256, MAIN_CHUNK, dtype=np.uint8).tobytes()
           + tail)
    mesh8 = [cuda0] * 8
    out = compress_sharded(dry, level=6, format="zlib", mesh=mesh8,
                           chunk_bytes=MAIN_CHUNK, mem_level=1)
    if zlib.decompress(out) != dry:
        raise AssertionError("dryrun cases: round trip failed")
    if out != zt.compress(dry, level=6, format="zlib", chunk_bytes=MAIN_CHUNK,
                          mem_level=1):
        raise AssertionError("dryrun cases: bytes != one card's")
    segs = encode_segments(dry, CodecConfig(level=6, chunk_bytes=MAIN_CHUNK,
                                            mem_level=1),
                           None, devices=mesh8)["segments"]
    # A stored block's header has BTYPE 00: bits 1-2 of its first byte.
    stored = [i for i, seg in enumerate(segs) if seg[0] & 6 == 0]
    if stored != [6]:
        raise AssertionError(f"dryrun cases: stored chunks {stored}, not [6]")
    oi = compress_sharded(dry, level=6, format="gzip", mesh=mesh8,
                          chunk_bytes=MAIN_CHUNK, indexed=True, seekable=True,
                          mem_level=1)
    if gzip.decompress(oi) != dry:
        raise AssertionError("dryrun cases: indexed round trip failed")
    off = MAIN_CHUNK * 6 - 100
    if zt.decompress_range(oi, off, 300) != dry[off : off + 300]:
        raise AssertionError("dryrun cases: decompress_range differs")
    log(f"dryrun_multichip cases on the card x8: {len(dry)} -> {len(out)} B "
        f"(uneven tail; chunk 6, the incompressible one, stored) == one card's; indexed + "
        f"seekable {len(oi)} B, decompress_range read verified")

    for nproc in MH_PROCS:
        ranks, blob = multihost_run(nproc)
        if blob != single:
            raise AssertionError(f"multihost {nproc}: bytes != one process's")
        if gzip.decompress(blob) != data:
            raise AssertionError(f"multihost {nproc}: output does not decode")
        for r in ranks:
            idle = [k for k in (*KERNELS, *CHECKSUMS)
                    if r["launches"][k] == 0]
            if idle:
                raise AssertionError(
                    f"multihost {nproc} rank {r['rank']}: never launched "
                    f"{idle}")
        wall = ranks[0]["secs"]
        dt = statistics.median(wall)
        log(f"multihost {nproc} processes on {ranks[0]['device']} (gloo): "
            f"root's {len(blob)} B == one process's and decode; wall from a "
            f"barrier to root's return, median {dt:.4f} s of {len(wall)} "
            f"(min {min(wall):.4f}, max {max(wall):.4f}) = {mb / dt:.3f} MB/s "
            f"aggregate against one process's {one_mbps:.3f}; per rank: "
            + "; ".join(f"rank {r['rank']} {r['nbytes']} B, launches "
                        f"{r['launches']}" for r in ranks))
        counts[f"multihost {nproc}"] = [r["launches"] for r in ranks]
        rates[f"multihost {nproc}"] = mb / dt
    return counts, rates, part, (rows, ends, starts)


def hostile_rows(np, n: int, seed: int):
    """Seeded (B, n) uint8 rows and their (ends, starts), int32: empty
    ranges at 0, inside and at n, a whole row, start > 0 with end < n,
    lengths 1-4, ranges across a kernel block's edge, and random ones."""
    from zzflate_tpu_torch.ops.kernels import CKS_BLOCK_BYTES as blk

    rng = np.random.default_rng(seed)
    cases = [(0, 0), (n // 2, n // 2), (n, n), (0, n), (1, n - 1), (3, 4),
             (3, 5), (7, 10), (n - 4, n), (n - 1, n), (5, 5 + blk),
             (n - blk - 3, n - 2)]
    cases += [tuple(sorted(int(v) for v in rng.integers(0, n + 1, 2)))
              for _ in range(4)]
    data = rng.integers(0, 256, (len(cases), n), np.uint8)
    data[1, : n // 3] = 0xFF  # the CRC init fold's own byte value
    ends = np.array([c[1] for c in cases], np.int32)
    starts = np.array([c[0] for c in cases], np.int32)
    return data, ends, starts


def zlib_rows(fn, data, ends, starts) -> list[int]:
    """fn (zlib.crc32 or adler32) of every row's range, on the host."""
    host = data.cpu().numpy()
    b = host.shape[0]
    if isinstance(ends, int):
        ends, starts = [ends] * b, [starts] * b
    else:
        ends, starts = ends.cpu().tolist(), starts.cpu().tolist()
    return [fn(host[r, starts[r] : ends[r]].tobytes()) for r in range(b)]


def cks_bound(name: str, data, ends, starts):
    """Least time of one call: max(bytes / HBM rate, ops / integer rate).
    Bytes: every byte of each row's range read once, the row bounds read
    (when they are tensors) and 8 B a row written. Ops: CKS_OPS_PER_BYTE
    a byte of the ranges."""
    b = data.shape[0]
    if isinstance(ends, int):
        nbytes, moved = (ends - starts) * b, 8 * b
    else:
        nbytes = int((ends.long() - starts.long()).sum().item())
        moved = 16 * b
    t_bytes = (nbytes + moved) / HBM_BYTES_PER_S * 1e3
    t_ops = nbytes * CKS_OPS_PER_BYTE[name] / INT_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def phase_checksums(torch, kernels, timer, decode, batch):
    """crc32_rows and adler32_rows against their plain versions and zlib
    on the real decode groups, the partials batch, a hostile batch and a
    64 MiB + 5 B row; time, bound and share per launch."""
    import numpy as np

    inputs = [(label, buf[None], end, start)
              for label, buf, end, start in decode["groups"]]
    rows, ends, starts = batch
    inputs.append((f"partials batch {tuple(rows.shape)}", rows, ends, starts))
    hd, he, hs = hostile_rows(np, CKS_ODD_WIDTH, seed=5)
    hd = torch.from_numpy(hd).cuda()
    inputs.append((f"hostile {tuple(hd.shape)}", hd,
                   torch.from_numpy(he).cuda(), torch.from_numpy(hs).cuda()))
    inputs.append((f"hostile {tuple(hd.shape)}, one shared range [17, N-2)",
                   hd, CKS_ODD_WIDTH - 2, 17))
    g = torch.Generator(device="cuda").manual_seed(8)
    big = torch.randint(0, 256, (1, CKS_BIG), generator=g, device="cuda",
                        dtype=torch.uint8)
    inputs.append(("64 MiB + 5 B row", big, CKS_BIG, 0))
    inputs.append(("64 MiB + 5 B row, [3, N-2)", big, CKS_BIG - 2, 3))
    # Timed: the first indexed decode group, the partials batch, the row.
    timed = [inputs[0], inputs[len(decode["groups"])], inputs[-2]]
    results = {}
    for name in CHECKSUMS:
        kfn = getattr(kernels, name)
        pfn = getattr(kernels, f"{name}_plain")
        zfn = zlib.crc32 if name == "crc32_rows" else zlib.adler32
        err = 0
        for label, data, e, s in inputs:
            got, exp = kfn(data, e, s), pfn(data, e, s)
            torch.cuda.synchronize()
            want = zlib_rows(zfn, data, e, s)
            if got.cpu().tolist() != want or exp.cpu().tolist() != want:
                raise AssertionError(f"{name} on {label}: kernel, plain and "
                                     "zlib differ")
            err = max(err, max_abs_err(torch, got, exp))
        per_launch = []
        for label, data, e, s in timed:
            ms = timer.kernel_ms(lambda: kfn(data, e, s))
            plain_ms = timer.wall_ms(lambda: pfn(data, e, s))
            b_ms, b_by, nbytes = cks_bound(name, data, e, s)
            per_launch.append({"input": label, "shape": list(data.shape),
                               "range_bytes": nbytes, "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "share": b_ms / ms})
            log(f"  {name} {label}: {nbytes} B of ranges, {ms:.4f} ms, "
                f"bound {b_ms * 1e3:.2f} us ({b_by}), share {b_ms / ms:.3f}; "
                f"plain {plain_ms:.4f} ms")
        # The main path's launch: a decode group's CRC, the partials' Adler.
        main = per_launch[0] if name == "crc32_rows" else per_launch[1]
        results[name] = {"max_abs_err": err, "ms": main["ms"],
                         "plain_ms": main["plain_ms"],
                         "bound_ms": main["bound_ms"],
                         "bound_by": main["bound_by"], "library_ms": None,
                         "per_launch": per_launch}
        log(f"kernel {name}: {len(inputs)} comparisons with its plain "
            f"version and zlib exact ({len(decode['groups'])} decode "
            f"groups, the partials batch, the hostile batch by tensor bounds "
            f"and by one range, the 64 MiB + 5 B row twice); library: none")
    return results


def multihost_run(nproc: int, nbytes: int = PAR_BYTES,
                  reps: int = PAR_REPS) -> tuple[list[dict], bytes]:
    """Spawn nproc workers of this script on mixed_corpus(nbytes, 2), wait
    for all; return each rank's report and the stream rank 0 wrote."""
    import shutil
    import socket
    import tempfile

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="zz_mh_")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--multihost-worker", str(port),
         str(nproc), str(r), tmp, str(nbytes), str(reps)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for r in range(nproc)]
    reports, errs = [], []
    try:
        for p in procs:
            out, err = p.communicate(timeout=MH_TIMEOUT)
            if p.returncode != 0:
                errs.append(f"rc {p.returncode}: {err[-3000:]}")
                continue
            reports.append(json.loads(out.strip().splitlines()[-1]))
        if errs:
            raise AssertionError(f"multihost {nproc}: worker failed: {errs}")
        with open(os.path.join(tmp, "stream.gz"), "rb") as f:
            blob = f.read()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return sorted(reports, key=lambda r: r["rank"]), blob


def multihost_worker(port: str, nproc: str, rank: str, tmp: str,
                     nbytes: str, reps: str) -> int:
    """One process of a multi-process run: its chunk-aligned range of
    mixed_corpus(nbytes, 2) through compress_multihost on its own card, a
    warm-up call, then `reps` calls each timed from a barrier to root's
    return; prints a JSON report as its last line."""
    import torch
    import torch.distributed as dist

    from zzflate_tpu_torch.api import _rank_device
    from zzflate_tpu_torch.ops import kernels
    from zzflate_tpu_torch.parallel import multihost
    from zzflate_tpu_torch.utils import corpus

    torch.set_num_threads(1)
    nproc, rank, reps = int(nproc), int(rank), int(reps)
    data = corpus.mixed_corpus(int(nbytes), seed=2)
    nch = -(-len(data) // MAIN_CHUNK)
    lo = min(nch * rank // nproc * MAIN_CHUNK, len(data))
    hi = min(nch * (rank + 1) // nproc * MAIN_CHUNK, len(data))
    local = data[lo:hi]
    multihost.initialize(f"tcp://127.0.0.1:{port}", nproc, rank)

    def call():
        return multihost.compress_multihost(local, level=6, format="gzip",
                                            chunk_bytes=MAIN_CHUNK)

    call()  # warm-up: allocations, kernel loads, the gloo connections
    kernels.reset_launches()
    secs, blob = [], None
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        blob = call()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        dist.barrier()  # root's return is the end of the timed call
    rep = {"rank": rank, "nbytes": len(local), "secs": secs,
           "device": torch.cuda.get_device_name(_rank_device(None, rank)),
           "launches": {k: v // reps for k, v in kernels.launches.items()}}
    if rank == 0:
        with open(os.path.join(tmp, "stream.gz"), "wb") as f:
            f.write(blob)
    dist.destroy_process_group()
    print(json.dumps(rep), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import zzflate_tpu_torch as zt
    from zzflate_tpu_torch import native
    from zzflate_tpu_torch.ops import kernels
    from zzflate_tpu_torch.utils import corpus, profiling

    t_start = time.perf_counter()
    t_last = [t_start]

    def took(phase: str) -> None:
        now = time.perf_counter()
        log(f"phase {phase}: {now - t_last[0]:.1f} s")
        t_last[0] = now

    name, smi = phase_card(torch, kernels, native)
    data = corpus.mixed_corpus(MAIN_BYTES, seed=0)
    timer = profiling.DeviceTimer()
    took("1 (card, builds, corpus)")
    results = phase_kernels(torch, kernels, zt, timer, data)
    took("2 (kernels)")
    counts, ref, rates = phase_main(torch, kernels, zt, profiling, data)
    took("3 (main path)")
    counts["stream_L6"] = phase_stream(torch, kernels, zt, profiling, data,
                                       ref[6], rates[6])
    took("4 (streaming)")
    phase_reference(torch, zt, data, corpus)
    took("5 (reference)")
    walk, decode_cks, commit, cand, scatter, resolve = phase_decode(
        torch, kernels, zt, profiling, timer, data, corpus)
    cand["launches_by_run"].update(
        {lv: c[CAND[0]] for lv, c in counts.items()})
    if any(c[CAND[0]] for c in counts.values()):
        raise AssertionError("decode_candidates launched in an encode run")
    took("6 (device decode)")
    par_counts, par_rates, partials, batch = phase_parallel(
        torch, kernels, zt, profiling, timer, corpus)
    took("7 (parallel)")
    cks = phase_checksums(torch, kernels, timer, decode_cks, batch)
    took("8 (checksum kernels)")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")

    line = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts["L6"][k],
         "launches_by_level": {
             **{lv: c[k] for lv, c in counts.items()},
             **{p: ([r[k] for r in c] if isinstance(c, list) else c[k])
                for p, c in par_counts.items()}},
         **results[k]}
        for k, (src, rep) in KERNELS.items()
    ] + [{"name": OPTIMAL[0], "route": "cuda", "source": OPTIMAL[1],
          "replaces": OPTIMAL[2], "launches": counts["L9"][OPTIMAL[0]],
          "launches_by_level": {lv: c[OPTIMAL[0]]
                                for lv, c in counts.items()},
          **results[OPTIMAL[0]]}
    ] + [{"name": WALK[0], "route": "cuda", "source": WALK[1],
          "replaces": WALK[2], **walk}] + [
        {"name": k[0], "route": "cuda", "source": k[1], "replaces": k[2],
         **entry} for k, entry in ((CAND, cand), (COMMIT, commit))] + [
        {"name": k[0], "route": "cuda", "source": k[1], "replaces": k[2],
         **entry} for k, entry in ((SCATTER, scatter), (RESOLVE, resolve))
    ] + [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": (decode_cks["launches_by_run"]["indexed"][k]
                      if k == "crc32_rows"
                      else par_counts["sharded make_mesh"][k]),
         "launches_by_run": {
             **{r: c[k] for r, c in decode_cks["launches_by_run"].items()},
             **{p: ([r[k] for r in c] if isinstance(c, list) else c[k])
                for p, c in par_counts.items()}},
         **cks[k]}
        for k, (src, rep) in CHECKSUMS.items()],
        "parallel": {"MBps": par_rates, "partials_one_batch": partials},
        "crc_4mib_group": decode_cks["crc_4mib_group"]}
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"]:
        sys.exit(multihost_worker(*sys.argv[2:8]))
    sys.exit(main())
