"""zzflate_tpu_torch: the zzflate codec on PyTorch and CUDA.

A port of the JAX package ``zzflate_tpu`` (which stays the reference) to
PyTorch, with the matcher's three TPU kernels rewritten as hand-written
CUDA kernels for Hopper (sm_90a). This slice covers ``compress`` at
levels 0-6: zlib, gzip and raw formats, preset dictionaries, window_bits,
mem_level, strategies and indexed/seekable gzip. Output bytes equal the
reference's.

    import zzflate_tpu_torch as zt
    blob = zt.compress(data, level=6, format="gzip")   # on the GPU
    blob = zt.compress(data, device="cpu")             # plain torch on the CPU
"""
from zzflate_tpu_torch.api import compress, compress_bound
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
    "CodecConfig",
    "STRATEGY_DEFAULT",
    "STRATEGY_FILTERED",
    "STRATEGY_FIXED",
    "STRATEGY_HUFFMAN_ONLY",
    "STRATEGY_RLE",
]
