"""Data-parallel encode over several devices of one process.

Port of ``zzflate_tpu/parallel/sharded.py``. DEFLATE's 32 KiB window
makes chunk parallelism legal: window-aligned chunks with a 32 KiB halo
(the previous chunk's tail as preset dictionary) compress independently,
and their sync-flush framed segments join into one valid zlib/gzip
member.

- The mesh is a list of torch devices (``make_mesh``). Each batch of the
  pipeline (``encode_pipeline.encode_segments(devices=mesh)``) gives
  every device its own rows: upload, analyze, emit and copies stay on
  that device, so nothing crosses devices in the hot path. A list may
  name one device more than once. The bytes equal compress()'s at
  chunk_bytes >= 32 KiB, or when the input fits one batch: a smaller
  chunk's halo is cut at a batch's first row (as in the reference), and
  the mesh moves the batch boundaries.
- Each chunk's Adler-32 and CRC-32 are computed on its device during
  analyze and merged in order on the host with the closed-form combines
  (``utils.containers.combine_adler``/``combine_crc``): the container
  trailer never reads the input again.
- The ordered join of the segments and the framing are host work,
  compress()'s own (``api._compress_on``).
"""
from __future__ import annotations

import torch

from zzflate_tpu_torch import config as cfg_mod
from zzflate_tpu_torch.api import _check_options, _compress_on
from zzflate_tpu_torch.config import CodecConfig
from zzflate_tpu_torch.devices import resolve_device


def make_mesh(devices=None) -> list[torch.device]:
    """The device list of the chunk (data-parallel) axis: every visible
    CUDA card for None (RuntimeError without one), else the given
    devices as they are (e.g. ["cpu"] * 8; a bare "cuda" is the current
    card)."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def compress_sharded(
    data: bytes,
    level: int = 6,
    format: str = "zlib",
    mesh: list | None = None,
    chunk_bytes: int = cfg_mod.DEFAULT_CHUNK_BYTES,
    dictionary: bytes | None = None,
    indexed: bool = False,
    seekable: bool = False,
    mem_level: int = 8,
) -> bytes:
    """One-shot compress with the chunk batches spread over `mesh`.

    The same bytes as zzflate_tpu_torch.compress with the same chunking
    (at chunk_bytes >= 32 KiB, or in one batch); only the device layout
    differs, and the stream checksums come from the devices' per-chunk
    partials combined in order. seekable and mem_level are compress()'s
    (window reset per chunk; per-device batch budget). mesh=None takes
    every CUDA card (make_mesh)."""
    data = bytes(data)
    config = CodecConfig(level=level, format=format, chunk_bytes=chunk_bytes,
                         mem_level=mem_level)
    _check_options(config, dictionary, indexed, seekable)
    return _compress_on(data, config, dictionary, make_mesh(mesh), indexed,
                        seekable, card_checksums=True)
