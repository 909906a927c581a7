"""zzflate_tpu_torch: the zzflate codec on PyTorch and CUDA.

A port of the JAX package ``zzflate_tpu`` (which stays the reference) to
PyTorch, with the matcher's three TPU kernels and device decode's token
walk as hand-written CUDA kernels for Hopper (sm_90a). It covers
``compress`` at levels 0-9 (levels 7-9 re-parse on the host with the
port's C runtime): zlib, gzip and raw formats, preset dictionaries,
window_bits, mem_level, strategies, indexed/seekable gzip and the host C
engine; ``decompress`` on the host (C decoder) or on the card
(``engine="device"``: indexed and foreign streams, ``models.inflate_device``)
and ``decompress_range``; streaming with zlib's five flush modes
(``stream``), the stdlib facades ``zlib_compat`` and ``gzip_compat``,
resumable shards (``utils.resume``) and the CLI (``python -m
zzflate_tpu_torch``). Output bytes equal the reference's.

    import zzflate_tpu_torch as zt
    blob = zt.compress(data, level=6, format="gzip")   # on the GPU
    blob = zt.compress(data, device="cpu")             # plain torch on the CPU
    data = zt.decompress(blob, format="gzip")          # C decoder on the host
    data = zt.decompress(blob, format="gzip", engine="device")  # on the GPU
    c = zt.zlib_compat.compressobj(6, wbits=31)        # streaming, on the GPU
"""
from zzflate_tpu_torch.api import (
    compress,
    compress_bound,
    decompress,
    decompress_range,
)
from zzflate_tpu_torch import gzip_compat, stream, zlib_compat
from zzflate_tpu_torch.config import (
    STRATEGY_DEFAULT,
    STRATEGY_FILTERED,
    STRATEGY_FIXED,
    STRATEGY_HUFFMAN_ONLY,
    STRATEGY_RLE,
    CodecConfig,
)

__all__ = [
    "compress",
    "compress_bound",
    "decompress",
    "decompress_range",
    "stream",
    "zlib_compat",
    "gzip_compat",
    "CodecConfig",
    "STRATEGY_DEFAULT",
    "STRATEGY_FILTERED",
    "STRATEGY_FIXED",
    "STRATEGY_HUFFMAN_ONLY",
    "STRATEGY_RLE",
]
