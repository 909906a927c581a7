"""Public one-shot API: compress and compress_bound.

Port of ``zzflate_tpu/api.py:24-165`` for levels 0-6 on the device
pipeline. Bytes in, bytes out, with the reference's level, format,
dictionary, window_bits, mem_level, strategy and indexed/seekable
options. Container checksums use the stdlib ``zlib`` functions: they are
host framing, not compression.

Device rule: ``device=None`` means CUDA and raises RuntimeError when no
GPU is present; only an explicit ``device="cpu"`` runs the plain torch
versions of the kernels on the CPU.
"""
from __future__ import annotations

import zlib as _zlib

import torch

from zzflate_tpu_torch import config as cfg_mod
from zzflate_tpu_torch.config import CodecConfig
from zzflate_tpu_torch.encode_pipeline import encode_segments
from zzflate_tpu_torch.utils import containers


def compress_bound(n: int, format: str = "zlib") -> int:
    """Worst-case compressed size (stored fallback bound), zlib.h:760 shape."""
    overhead = {"raw": 0, "zlib": 2 + 4 + 4, "gzip": 10 + 8}[format]
    return n + 5 * (n // 65535 + 1) + 2 + overhead


def _resolve_device(device) -> torch.device:
    """None -> CUDA (RuntimeError without a GPU); otherwise as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain torch "
                "path on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def compress(
    data: bytes,
    level: int = 6,
    format: str = "zlib",
    dictionary: bytes | None = None,
    chunk_bytes: int = cfg_mod.DEFAULT_CHUNK_BYTES,
    strategy: int = cfg_mod.STRATEGY_DEFAULT,
    indexed: bool = False,
    window_bits: int = 15,
    mem_level: int = 8,
    seekable: bool = False,
    device: str | torch.device | None = None,
) -> bytes:
    """One-shot compress to a zlib/gzip/raw stream (decodable by zlib).

    indexed=True (gzip only) adds a 'ZZ' FEXTRA subfield with the
    per-chunk compressed sizes, block and anchor offsets; seekable=True
    (requires indexed) also resets the LZ window at every chunk boundary
    so any chunk decodes from its own segment. window_bits 8..15 bounds
    match distances to 2^window_bits.
    """
    data = bytes(data)
    config = CodecConfig(
        level=level, format=format, chunk_bytes=chunk_bytes,
        strategy=strategy, window_bits=window_bits, mem_level=mem_level,
    )
    if level >= 7:
        raise NotImplementedError("levels 7-9 come with the optimal-parse slice")
    if dictionary is not None and format == "gzip":
        raise ValueError("gzip streams cannot carry a preset dictionary")
    if indexed and format != "gzip":
        raise ValueError("indexed output requires format='gzip'")
    if seekable and not indexed:
        raise ValueError("seekable output requires indexed=True")
    if indexed and level == 0:
        raise ValueError("indexed output requires level >= 1")
    dev = _resolve_device(device)

    segments: list[bytes] | None = None
    if level == 0:
        payload = containers.stored_segment(data, final=True)
    else:
        enc = encode_segments(
            data, config, dictionary, dev, with_anchors=indexed,
            halo=not seekable,
        )
        segments = enc["segments"]
        payload = b"".join(segments)
        # Whole-stream stored fallback: per-chunk sync-flush framing adds
        # ~5 bytes/chunk, so incompressible inputs could otherwise exceed
        # compress_bound. Indexed streams keep their per-chunk layout.
        if not indexed:
            stored_whole = containers.stored_segment(data, final=True)
            if len(stored_whole) < len(payload):
                payload = stored_whole
                segments = None

    if format == "raw":
        return payload
    if format == "zlib":
        dictid = _zlib.adler32(dictionary) if dictionary is not None else None
        return (
            containers.zlib_header(level, dictid, config.window_bits)
            + payload
            + containers.zlib_trailer(_zlib.adler32(data))
        )
    if indexed and segments is not None:
        hdr = containers.gzip_header_indexed(
            chunk_bytes,
            list(zip((len(s) for s in segments), enc["blocks"],
                     enc["anchors"])),
            flags=containers.ZZ_FLAG_SEEKABLE if seekable else 0,
        )
    else:
        hdr = containers.gzip_header()
    return hdr + payload + containers.gzip_trailer(_zlib.crc32(data), len(data))
