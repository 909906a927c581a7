"""Distributed encode of one byte stream split across processes.

Port of ``zzflate_tpu/parallel/multihost.py`` over ``torch.distributed``.
The chunk scheme is lifted one level: process i holds a contiguous byte
range (process order = byte order) and encodes it on its own device; its
first chunk takes process i-1's 32 KiB tail as its preset dictionary
(the halo: one all-gather of the tails); every process's payload is
sync-flush framed and the last one closes the stream; process 0 joins
the payloads in order and merges the per-process checksum partials with
the closed-form combines. The result is one valid zlib/gzip member, the
bytes a single process would write with the same chunking, provided
every range is chunk-aligned and at least 32 KiB long (a shorter range
would leave the next process a shorter dictionary than the single
process's halo), chunks are at least 32 KiB (a smaller chunk's halo
reaches back past its process's first chunk, where it is cut, as at a
batch's first row) and the input is compressible (there is no
whole-stream stored fallback here). Otherwise the stream still decodes.

Everything exchanged is host bytes, so the collectives run over gloo:
the default group when it is gloo, else one gloo group made at the first
call (NCCL takes device tensors only and one card per rank). The small
metadata (tails, sizes, checksums) moves by all-gather; each ragged
payload goes point to point to process 0 (``dist.send``/``dist.recv``),
O(total compressed bytes) on the wire. The reference needs a probe
subprocess, an environment switch and a slab all-gather fallback because
``jax.experimental.transfer`` is missing on some clients; gloo's
send/recv exists everywhere, so none of them has a counterpart here. At
world size 1, without a process group, it runs as a single process.
"""
from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from zzflate_tpu_torch import config as cfg_mod
from zzflate_tpu_torch.api import _stream_checksums
from zzflate_tpu_torch.config import CodecConfig
from zzflate_tpu_torch.devices import rank_device
from zzflate_tpu_torch.encode_pipeline import encode_segments
from zzflate_tpu_torch.ops.checksums import adler32_combine, crc32_combine
from zzflate_tpu_torch.utils import containers

_WINDOW = 32768
_TIMEOUT = datetime.timedelta(seconds=60)


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str = "gloo") -> None:
    """Join the process group (a no-op when this process already has one).
    init_method is e.g. "tcp://host:port"; None reads the environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). A failure to connect
    within 60 s raises."""
    if dist.is_initialized():
        return
    kw = {"backend": backend, "timeout": _TIMEOUT}
    if init_method is not None:
        kw["init_method"] = init_method
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(**kw)


_gloo: tuple | None = None  # (default group, its gloo group)


def _group():
    """The group of every exchange: the default group when its backend is
    gloo, else a gloo group over all ranks, made once per default group
    (new_group is collective: every rank makes it at its first call)."""
    global _gloo
    world = dist.group.WORLD
    if dist.get_backend() == "gloo":
        return world
    if _gloo is None or _gloo[0] is not world:
        _gloo = (world, dist.new_group(backend="gloo"))
    return _gloo[1]


def _world() -> tuple[int, int]:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _allgather_np(arr: np.ndarray) -> np.ndarray:
    """All-gather a host-local array of the same shape on every rank
    along a new leading axis."""
    if _world()[1] == 1:
        return arr[None]
    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t, group=_group())
    return torch.stack(out).numpy()


def _gather_payloads_to_root(payload: bytes, metas: np.ndarray, pid: int,
                             nproc: int) -> list[bytes] | None:
    """Every rank's ragged payload on rank 0, sent point to point; sizes
    come from the gathered metas, and an empty payload sends nothing.
    Returns the per-rank list on rank 0, None elsewhere."""
    if nproc == 1:
        return [payload] if pid == 0 else None
    group = _group()
    if pid != 0:
        if payload:
            buf = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
            dist.send(buf, dst=0, group=group)
        return None
    out = [payload]
    for i in range(1, nproc):
        n = int(metas[i, 0])
        if n == 0:
            out.append(b"")
            continue
        buf = torch.empty(n, dtype=torch.uint8)
        dist.recv(buf, src=i, group=group)
        out.append(buf.numpy().tobytes())
    return out


def compress_multihost(
    local_data: bytes,
    level: int = 6,
    format: str = "gzip",
    chunk_bytes: int = cfg_mod.DEFAULT_CHUNK_BYTES,
    use_halo: bool = True,
    device=None,
) -> bytes | None:
    """Distributed one-shot compress of a byte stream split across the
    processes of the default group.

    Each process passes its contiguous range (process order = byte
    order) and encodes it on `device`: None is the process's own card,
    cuda:(LOCAL_RANK or rank) % device_count (RuntimeError without one).
    Returns the complete stream on process 0, None elsewhere."""
    local_data = bytes(local_data)
    config = CodecConfig(level=level, format=format, chunk_bytes=chunk_bytes)
    pid, nproc = _world()
    dev = rank_device(device, pid)

    # Halo: every process publishes its 32 KiB tail; process i seeds its
    # first chunk with process i-1's.
    tail = np.zeros(_WINDOW + 4, np.uint8)
    t = local_data[-_WINDOW:]
    tail[: len(t)] = np.frombuffer(t, np.uint8)
    tail[_WINDOW:] = np.frombuffer(
        np.array([len(t)], np.uint32).tobytes(), np.uint8
    )
    tails = _allgather_np(tail)
    dictionary = None
    if use_halo and pid > 0:
        prev_len = int(
            np.frombuffer(tails[pid - 1, _WINDOW:].tobytes(), np.uint32)[0]
        )
        dictionary = tails[pid - 1, :prev_len].tobytes()

    res = encode_segments(local_data, config, dictionary, [dev],
                          stream_final=pid == nproc - 1, with_checksums=True)
    payload = b"".join(res["segments"])
    adler, crc = _stream_checksums(res, len(local_data), chunk_bytes)

    # Sizes and checksums to everyone, then the payloads to process 0.
    meta = np.array([len(payload), len(local_data), adler, crc], np.int64)
    metas = _allgather_np(meta)
    per_rank = _gather_payloads_to_root(payload, metas, pid, nproc)
    if pid != 0:
        return None

    full_payload = b"".join(per_rank)
    full_adler, full_crc = 1, 0
    for i in range(nproc):
        ln = int(metas[i, 1])
        full_adler = adler32_combine(full_adler, int(metas[i, 2]), ln)
        full_crc = crc32_combine(full_crc, int(metas[i, 3]), ln)
    if format == "raw":
        return full_payload
    if format == "zlib":
        return (containers.zlib_header(level) + full_payload
                + containers.zlib_trailer(full_adler))
    return (containers.gzip_header() + full_payload
            + containers.gzip_trailer(full_crc, int(metas[:, 1].sum())))
