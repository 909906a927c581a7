"""zzflate_tpu_torch.parallel and the per-chunk checksum partials against
zzflate_tpu on the CPU.

compress_sharded over meshes of 1, 2, 3 and 8 CPU entries must give the
reference's compress_sharded bytes on its 8-device CPU mesh (and the
port's one-device compress); compress_multihost must give the
reference's at world size 1 and, in real 2- and 3-process gloo runs,
the single-process bytes. The per-row Adler-32/CRC-32 partials must
equal zlib's and the reference's under jax.vmap. Tolerance is zero: the
codec is integer-only and deterministic.

Compile budget: every sharded case stays at 8 chunks of 4 KiB or fewer,
so the reference runs one mesh shape, (8, 36864); the reference's
vmapped CRC compiles about 20 s a width, so it runs at the main path's
width alone, and the odd width is held to zlib.
"""
import functools
import gzip
import os
import socket
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import zzflate_tpu as zf
from zzflate_tpu import native as jax_native
from zzflate_tpu.api import _encode_segments as ref_encode_segments
from zzflate_tpu.config import CodecConfig as RefConfig
from zzflate_tpu.ops import checksums as ref_cs
from zzflate_tpu.parallel import compress_sharded as ref_compress_sharded
from zzflate_tpu.parallel import make_mesh as ref_make_mesh
from zzflate_tpu.parallel.multihost import (
    compress_multihost as ref_compress_multihost,
)

import zzflate_tpu_torch as zt
from zzflate_tpu_torch import devices
from zzflate_tpu_torch.config import LEVELS, CodecConfig
from zzflate_tpu_torch.encode_pipeline import build_chunk_batch, encode_segments
from zzflate_tpu_torch.models import deflate_encoder
from zzflate_tpu_torch.ops import checksums as cs
from zzflate_tpu_torch.parallel import compress_sharded, make_mesh, multihost
from zzflate_tpu_torch.utils import profiling
from zzflate_tpu_torch.utils.corpus import mixed_corpus

# The test processes share the CPU. With torch's default intra-op pool in
# each of them it is oversubscribed, and a CPU-path call runs tens of
# times slower; one thread apiece keeps the suite inside its time limit.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 4096
MESHES = [1, 2, 3, 8]


def _data(n, seed):
    """Half repetitive text, half noise (tests/test_parallel.py's shape)."""
    rng = np.random.default_rng(seed)
    text = (b"mesh sharded deflate chunk test " * 800)[: n // 2]
    return text + rng.integers(0, 256, n - len(text), np.uint8).tobytes()


# ---------------------------------------------------------------------------
# Per-row partials.
# ---------------------------------------------------------------------------

# width: the main path's 256 KiB rows (9 x 2^15), and one that is not a
# multiple of 1024 (the CRC's odd tree levels; Adler pads to 1024).
MAIN_WIDTH = 32768 + (1 << 18)
WIDTHS = {"294912": MAIN_WIDTH, "odd-37197": 37197}


def _rows(width, seed):
    """Seeded (6, width) rows and their [start, end): a chunk behind a
    dictionary prefix, a short last row, an empty range (a padded row),
    a whole row from 0, and two random ranges."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (6, width), np.uint8)
    data[1, :500] = 7  # a highly compressible stretch
    starts = np.array([32768, 32768, 32768, 0, 0, 0], np.int64)
    ends = np.array([width, 32768 + 1234, 32768, width, 0, 0], np.int64)
    for r in (4, 5):
        lo, hi = sorted(rng.integers(0, width + 1, 2))
        starts[r], ends[r] = lo, hi
    return data, starts, ends


@pytest.mark.parametrize("width", list(WIDTHS.values()), ids=list(WIDTHS))
def test_row_partials_equal_zlib_and_reference(width):
    data, starts, ends = _rows(width, seed=width)
    t = torch.from_numpy(data)
    adler = cs.adler32_rows(t, torch.from_numpy(ends), torch.from_numpy(starts))
    crc = cs.crc32_rows(t, torch.from_numpy(ends), torch.from_numpy(starts))
    assert adler.dtype == crc.dtype == torch.int64 and adler.shape == (6,)
    for r in range(6):
        seg = data[r, starts[r] : ends[r]].tobytes()
        assert int(adler[r]) == zlib.adler32(seg), r
        assert int(crc[r]) == zlib.crc32(seg), r
    assert int(adler[2]) == 1 and int(crc[2]) == 0  # the empty range
    if width != MAIN_WIDTH:
        return  # one reference shape: zlib holds the odd width
    jd, je, js = (jnp.asarray(data), jnp.asarray(ends.astype(np.int32)),
                  jnp.asarray(starts.astype(np.int32)))
    ref_crc = jax.vmap(lambda d, e, s: ref_cs._crc32_impl(d, e, s))(jd, je, js)
    assert np.asarray(ref_crc).astype(np.int64).tolist() == crc.tolist()
    ref_adler = jax.vmap(
        lambda d, e, s: ref_cs._adler32_impl(d, e, s))(jd, je, js)
    assert np.asarray(ref_adler).astype(np.int64).tolist() == adler.tolist()


def test_analyze_checksums_equal_partials():
    """analyze_chunks_batch(with_checksums=True) covers each chunk's own
    bytes: not its dictionary or halo prefix, not a padded row."""
    data = mixed_corpus(3 * CHUNK + 555, 41)
    dictionary = mixed_corpus(5000, 42)
    buf, vends, wstarts, n = build_chunk_batch(data, CHUNK, dictionary)
    buf = np.concatenate([buf, np.zeros((1, buf.shape[1]), np.uint8)])
    vends = np.append(vends, 32768).astype(np.int32)
    wstarts = np.append(wstarts, 32768).astype(np.int32)
    starts = np.full(n + 1, 32768, np.int32)
    ana = deflate_encoder.analyze_chunks_batch(
        *(torch.as_tensor(a) for a in (buf, starts, vends, wstarts)),
        LEVELS[6], with_checksums=True,
    )
    want = [(zlib.adler32(data[i * CHUNK : (i + 1) * CHUNK]),
             zlib.crc32(data[i * CHUNK : (i + 1) * CHUNK])) for i in range(n)]
    want.append((1, 0))
    assert ana["cks"].tolist() == [list(w) for w in want]
    assert ana["adler"].tolist() == [w[0] for w in want]
    assert ana["crc"].tolist() == [w[1] for w in want]
    t = torch.as_tensor(buf)
    assert torch.equal(ana["adler"], cs.adler32_rows(t, vends, starts))
    assert torch.equal(ana["crc"], cs.crc32_rows(t, vends, starts))


PARTIALS_DATA = _data(7 * CHUNK + 100, seed=5)


@functools.cache
def _partials_expected():
    return ref_encode_segments(PARTIALS_DATA,
                               RefConfig(level=6, chunk_bytes=CHUNK), None,
                               mesh=ref_make_mesh(), with_checksums=True)


@pytest.mark.parametrize("k", MESHES)
def test_pipeline_partials_equal_reference(k):
    """encode_segments over k devices: the single device's segments, and
    the reference's per-chunk partials on its mesh (the graph its
    compress_sharded cases compile)."""
    data = PARTIALS_DATA
    exp = _partials_expected()
    cfg = CodecConfig(level=6, chunk_bytes=CHUNK)
    got = encode_segments(data, cfg, None, devices=["cpu"] * k,
                          with_checksums=True)
    one = encode_segments(data, cfg, None, torch.device("cpu"))
    assert got["segments"] == exp["segments"] == one["segments"]
    assert got["adler"] == [int(x) for x in exp["adler"]]
    assert got["crc"] == [int(x) for x in exp["crc"]]
    assert one["adler"] is None and one["crc"] is None


# ---------------------------------------------------------------------------
# compress_sharded.
# ---------------------------------------------------------------------------

DICTIONARY = b"dictionary payload for every chunk " * 50
SHARDED_CASES = {
    "zlib": (_data(7 * CHUNK + 100, 5), dict(format="zlib")),
    "gzip": (_data(4 * CHUNK, 2), dict(format="gzip")),
    "raw": (_data(4 * CHUNK, 3), dict(format="raw")),
    "uneven-tail": (_data(CHUNK * 3 + 17, 6), dict(format="zlib")),
    "dictionary": (b"dictionary payload for every chunk -- body " * 300,
                   dict(format="zlib", dictionary=DICTIONARY)),
    "level-0": (_data(4 * CHUNK, 7), dict(format="gzip", level=0)),
    "indexed-seekable": (mixed_corpus(6 * CHUNK + 300, 8),
                         dict(format="gzip", indexed=True, seekable=True)),
    "level-9": (mixed_corpus(5 * CHUNK, 9), dict(format="gzip", level=9)),
}


@functools.cache
def _sharded_expected(case):
    data, kw = SHARDED_CASES[case]
    kw = dict(kw)
    level = kw.pop("level", 6)
    if level == 9:
        # Without its C library the reference keeps the lazy parse.
        assert jax_native.lib() is not None
    ref = ref_compress_sharded(data, level=level, chunk_bytes=CHUNK, **kw)
    one = zt.compress(data, level=level, chunk_bytes=CHUNK, device="cpu",
                      **kw)
    return ref, one


def _decode(out, kw):
    fmt = kw.get("format", "zlib")
    if fmt == "raw":
        return zlib.decompress(out, wbits=-15)
    if fmt == "gzip":
        return gzip.decompress(out)
    d = zlib.decompressobj(zdict=kw["dictionary"]) if "dictionary" in kw \
        else zlib.decompressobj()
    return d.decompress(out) + d.flush()


@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_sharded_equals_reference(case, k):
    data, kw = SHARDED_CASES[case]
    ref, one = _sharded_expected(case)
    got = compress_sharded(data, mesh=["cpu"] * k, chunk_bytes=CHUNK, **kw)
    assert got == ref == one
    assert _decode(got, kw) == data
    if kw.get("indexed"):
        # A random-access read, as __graft_entry__.dryrun_multichip does.
        off = 3 * CHUNK - 100
        assert zt.decompress_range(got, off, 300) == data[off : off + 300]


@pytest.mark.parametrize("k", [2, 3])
def test_sharded_layout_needs_32k_chunks_across_batches(k):
    """Several batches (mem_level=1): at 32 KiB chunks every halo lies in
    the previous chunk and the bytes do not depend on the mesh. At 4 KiB
    a chunk's halo reaches back several chunks, and the pipeline cuts it
    at a batch's first row, as the reference's does (test_torch_api's
    test_multi_batch_equals_reference holds the port to it): the mesh
    moves the batch boundaries, so the bytes differ, and still decode."""
    corpus = mixed_corpus(6 * 32768 + 5, 3)
    data = corpus[: 3 * 32768 + 5]
    one = zt.compress(data, chunk_bytes=32768, mem_level=1, device="cpu")
    got = compress_sharded(data, chunk_bytes=32768, mem_level=1,
                           mesh=["cpu"] * k)
    assert got == one
    small = corpus[: 16 * CHUNK]
    one = zt.compress(small, chunk_bytes=CHUNK, mem_level=1, device="cpu")
    got = compress_sharded(small, chunk_bytes=CHUNK, mem_level=1,
                           mesh=["cpu"] * k)
    assert got != one and zlib.decompress(got) == small


def test_sharded_checks_as_the_reference():
    for kw in (dict(format="gzip", dictionary=b"x"),
               dict(format="zlib", indexed=True),
               dict(format="gzip", seekable=True),
               dict(format="gzip", indexed=True, level=0)):
        with pytest.raises(ValueError):
            compress_sharded(b"abc", mesh=["cpu"], **kw)


# ---------------------------------------------------------------------------
# No hidden fallback: no card, no CUDA default.
# ---------------------------------------------------------------------------


def test_mesh_and_rank_defaults_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults run there")
    with pytest.raises(RuntimeError):
        make_mesh()
    with pytest.raises(RuntimeError):
        compress_sharded(b"abc")
    with pytest.raises(RuntimeError):
        multihost.compress_multihost(b"abc")
    assert make_mesh(["cpu"] * 3) == [torch.device("cpu")] * 3


def test_rank_device_rule(monkeypatch):
    """None -> cuda:(LOCAL_RANK or rank) % device_count; a given device
    stays as it is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert devices.rank_device(None, 0) == torch.device("cuda", 0)
    assert devices.rank_device(None, 4) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert devices.rank_device(None, 7) == torch.device("cuda", 2)
    assert devices.rank_device("cpu", 7) == torch.device("cpu")
    assert devices.rank_device("cuda:1", 0) == torch.device("cuda", 1)


# ---------------------------------------------------------------------------
# Profiling: a stage over a mesh, a trace's stage ranges.
# ---------------------------------------------------------------------------


def test_stage_synchronises_every_device_of_a_mesh(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    mesh = [torch.device("cuda", 0), torch.device("cuda", 1),
            torch.device("cuda", 0), torch.device("cpu")]
    with profiling.collect() as t:
        with profiling.maybe_stage("analyze_dispatch", mesh):
            pass
        with profiling.maybe_stage("one", torch.device("cuda", 1)):
            pass
        with profiling.maybe_stage("host"):
            pass
    assert synced == [torch.device("cuda", 0), torch.device("cuda", 1),
                      torch.device("cuda", 1)]
    assert set(t.as_ms()) == {"analyze_dispatch", "one", "host"}
    synced.clear()
    with profiling.maybe_stage("off", mesh):  # no collector: no sync
        pass
    assert synced == []


def test_trace_writes_stage_ranges(tmp_path):
    with profiling.collect() as st:
        with profiling.trace(str(tmp_path)):
            compress_sharded(_data(CHUNK, 1), mesh=["cpu"] * 2,
                             chunk_bytes=CHUNK)
    traces = [p for p in tmp_path.iterdir() if p.name.endswith(".json.gz")]
    assert traces
    import json

    with gzip.open(traces[0], "rt") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "stage:analyze_dispatch" in names
    assert "analyze_dispatch" in st.as_ms()


# ---------------------------------------------------------------------------
# compress_multihost: world size 1, the group rule, real processes.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["gzip", "zlib"])
def test_multihost_single_process_equals_reference(fmt):
    data = _data(4 * CHUNK - 300, seed=11)
    exp = ref_compress_multihost(data, level=6, format=fmt, chunk_bytes=CHUNK)
    got = multihost.compress_multihost(data, level=6, format=fmt,
                                       chunk_bytes=CHUNK, device="cpu")
    assert got == exp
    assert zlib.decompress(got, wbits=31 if fmt == "gzip" else 15) == data


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_group_is_gloo_default_or_a_gloo_subgroup(monkeypatch):
    """A gloo default group is used as it is; under any other backend a
    gloo group is made once (collectively) and reused."""
    multihost.initialize(f"tcp://127.0.0.1:{_free_port()}", 1, 0)
    try:
        made = []
        monkeypatch.setattr(dist, "new_group",
                            lambda **kw: made.append(kw) or object())
        assert multihost._group() is dist.group.WORLD
        assert made == []
        multihost.initialize("tcp://127.0.0.1:1", 1, 0)  # joined: a no-op
        out = multihost.compress_multihost(_data(CHUNK, 12), device="cpu",
                                           chunk_bytes=CHUNK)
        assert gzip.decompress(out) == _data(CHUNK, 12)
        monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
        g = multihost._group()
        assert made == [{"backend": "gloo"}]
        assert multihost._group() is g and len(made) == 1
    finally:
        multihost._gloo = None
        dist.destroy_process_group()


# Each process compresses its chunk-aligned range of MH_DATA on the CPU
# over gloo and rank 0 writes the stream. The single process's bytes come
# out only where its halos do: every range is at least 32 KiB (each
# rank's dictionary is the single process's halo), chunks are 32 KiB (a
# smaller chunk's halo reaches back past its rank's first chunk, which
# both packages cut there, as at a batch's first row), and the corpus is
# compressible (no whole-stream stored fallback here). The splits are
# uneven (2 + 3 and 1 + 2 + 2 chunks, the last one short).
MH_CHUNK = 32768
MH_DATA = mixed_corpus(5 * MH_CHUNK - 1000, 13)
WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
from zzflate_tpu_torch.parallel import multihost
from zzflate_tpu_torch.utils.corpus import mixed_corpus
port, n, rank, chunk, nbytes, out = sys.argv[1:]
n, rank, chunk, nbytes = int(n), int(rank), int(chunk), int(nbytes)
data = mixed_corpus(nbytes, 13)
per = -(-len(data) // chunk)
cuts = [min(per * i // n * chunk, len(data)) for i in range(n + 1)]
multihost.initialize(f"tcp://127.0.0.1:{port}", n, rank)
blob = multihost.compress_multihost(data[cuts[rank]:cuts[rank + 1]],
                                    level=6, format="gzip",
                                    chunk_bytes=chunk, device="cpu")
assert (blob is None) == (rank != 0)
if rank == 0:
    with open(out, "wb") as f:
        f.write(blob)
torch.distributed.destroy_process_group()
"""


@functools.cache
def _mh_expected():
    return zf.compress(MH_DATA, level=6, format="gzip", chunk_bytes=MH_CHUNK)


@pytest.mark.parametrize("nprocs", [2, 3])
def test_multihost_processes_equal_single_process(tmp_path, nprocs):
    per = -(-len(MH_DATA) // MH_CHUNK)
    sizes = [min(per * (i + 1) // nprocs * MH_CHUNK, len(MH_DATA))
             - per * i // nprocs * MH_CHUNK for i in range(nprocs)]
    assert min(sizes) >= 32768
    out = tmp_path / "out.gz"
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(port), str(nprocs), str(r),
             str(MH_CHUNK), str(len(MH_DATA)), str(out)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for r in range(nprocs)
    ]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            errs.append((p.returncode, err.decode()[-2000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(rc == 0 for rc, _ in errs), errs
    blob = out.read_bytes()
    assert gzip.decompress(blob) == MH_DATA
    assert blob == _mh_expected()
    assert blob == zt.compress(MH_DATA, level=6, format="gzip",
                               chunk_bytes=MH_CHUNK, device="cpu")
