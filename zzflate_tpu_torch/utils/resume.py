"""Resumable sharded compression.

Port of ``zzflate_tpu/utils/resume.py``. The input is split into shards;
each shard compresses to an independent sync-flush-framed segment file
(``encode_segments(stream_final=False)``) plus a manifest entry
(compressed size, length, Adler-32 and CRC-32). A crashed or partly
failed run encodes again only the missing shards, and ``assemble``
joins the segments in order, closes the stream with a final empty block
and combines the checksums into one zlib/gzip/raw stream without reading
the input again.
"""
from __future__ import annotations

import json
import os

from zzflate_tpu_torch import config as cfg_mod
from zzflate_tpu_torch import native
from zzflate_tpu_torch.config import CodecConfig
from zzflate_tpu_torch.devices import resolve_device
from zzflate_tpu_torch.encode_pipeline import encode_segments
from zzflate_tpu_torch.ops.checksums import adler32_combine, crc32_combine
from zzflate_tpu_torch.utils import containers

_MANIFEST = "manifest.json"


def _shard_path(outdir: str, i: int) -> str:
    return os.path.join(outdir, f"shard_{i:06d}.seg")


def compress_to_dir(
    data: bytes,
    outdir: str,
    shard_bytes: int = 16 << 20,
    level: int = 6,
    chunk_bytes: int = cfg_mod.DEFAULT_CHUNK_BYTES,
    device=None,
) -> dict:
    """Compress `data` into per-shard segment files and a manifest.

    Shards already on disk and in the manifest are skipped, so a run
    after a crash or a lost file encodes only what is missing. `device`
    as in ``api.compress`` (None means CUDA and raises RuntimeError
    without a card). Returns the manifest."""
    dev = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    mpath = os.path.join(outdir, _MANIFEST)
    manifest = {
        "shard_bytes": shard_bytes,
        "chunk_bytes": chunk_bytes,
        "level": level,
        "total_len": len(data),
        "shards": {},
    }
    if os.path.exists(mpath):
        with open(mpath) as f:
            old = json.load(f)
        if (
            old.get("shard_bytes") == shard_bytes
            and old.get("total_len") == len(data)
            and old.get("level") == level
        ):
            manifest = old

    nshards = max(1, -(-len(data) // shard_bytes))
    config = CodecConfig(level=level, format="raw", chunk_bytes=chunk_bytes)
    for i in range(nshards):
        key = str(i)
        if key in manifest["shards"] and os.path.exists(_shard_path(outdir, i)):
            continue
        shard = data[i * shard_bytes : (i + 1) * shard_bytes]
        res = encode_segments(shard, config, None, [dev], stream_final=False)
        seg = b"".join(res["segments"])
        with open(_shard_path(outdir, i), "wb") as f:
            f.write(seg)
        manifest["shards"][key] = {
            "bytes": len(seg),
            "length": len(shard),
            "adler": native.adler32(shard),
            "crc": native.crc32(shard),
        }
        with open(mpath, "w") as f:
            json.dump(manifest, f)
    return manifest


def missing_shards(outdir: str) -> list[int]:
    """Shard indices not yet on disk (what a re-dispatch loop encodes)."""
    mpath = os.path.join(outdir, _MANIFEST)
    if not os.path.exists(mpath):
        return []
    with open(mpath) as f:
        manifest = json.load(f)
    n = max(1, -(-manifest["total_len"] // manifest["shard_bytes"]))
    return [
        i
        for i in range(n)
        if str(i) not in manifest["shards"]
        or not os.path.exists(_shard_path(outdir, i))
    ]


def assemble(outdir: str, format: str = "gzip") -> bytes:
    """Join the shard segments into one valid zlib/gzip/raw stream."""
    with open(os.path.join(outdir, _MANIFEST)) as f:
        manifest = json.load(f)
    n = max(1, -(-manifest["total_len"] // manifest["shard_bytes"]))
    payload = bytearray()
    adler, crc, total = 1, 0, 0
    for i in range(n):
        meta = manifest["shards"][str(i)]
        with open(_shard_path(outdir, i), "rb") as f:
            payload += f.read()
        adler = adler32_combine(adler, meta["adler"], meta["length"])
        crc = crc32_combine(crc, meta["crc"], meta["length"])
        total += meta["length"]
    payload += containers.FINAL_EMPTY_FIXED_BLOCK
    if format == "raw":
        return bytes(payload)
    if format == "zlib":
        return (
            containers.zlib_header(manifest["level"])
            + bytes(payload)
            + containers.zlib_trailer(adler)
        )
    return (
        containers.gzip_header()
        + bytes(payload)
        + containers.gzip_trailer(crc, total)
    )
