"""Adler-32 and CRC-32 on the data's device, and the host combine math
that stitches partials.

The port's own copy of ``zzflate_tpu/ops/checksums.py``. The host
combines (``ops/checksum_math``, re-exported here) stitch per-shard or
per-group partials in order (``utils/resume``, ``models/inflate_device``,
``parallel``). ``crc32_rows`` and ``adler32_rows`` give one checksum per
row of a (B, N) batch, every row at once: the encode's per-chunk
partials. ``crc32``, ``adler32`` and the reference's ``_crc32_impl`` and
``_adler32_impl`` are one-row calls of them: device decode verifies
every group's CRC-32 on the card, and only 4 bytes of it come back.
Whole-buffer containers use the stdlib ``zlib`` checksums, the stream
layer the C runtime's.

On a CUDA tensor every entry launches the hand-written kernels
(``ops/kernels.crc32_rows``/``adler32_rows``, ``csrc/checksum.cu``),
which take any length; on a CPU tensor their plain torch versions run.
Results are int64 tensors holding u32 values, with no host sync.
"""
from __future__ import annotations

import torch

from zzflate_tpu_torch.ops import kernels
from zzflate_tpu_torch.ops.checksum_math import (  # noqa: F401 (re-exports)
    adler32_combine,
    crc32_combine,
)

_BLOCK = kernels.ADLER_BLOCK


def crc32_rows(data: torch.Tensor, ends, starts) -> torch.Tensor:
    """CRC-32 of data[b, starts[b]:ends[b]] for every row b of a (B, N)
    uint8 tensor (0 <= start <= end <= N; any N), on the data's device.
    Returns (B,) int64 holding u32 values; an empty range gives 0."""
    return kernels.crc32_rows(data.contiguous(), ends, starts)


def adler32_rows(data: torch.Tensor, ends, starts) -> torch.Tensor:
    """Adler-32 of data[b, starts[b]:ends[b]] for every row b of a (B, N)
    uint8 tensor (0 <= start <= end <= N), on the data's device. Returns
    (B,) int64 holding u32 values; an empty range gives 1."""
    return kernels.adler32_rows(data.contiguous(), ends, starts)


def _crc32_impl(data: torch.Tensor, length: int, start: int = 0):
    """CRC-32 of data[start:length] (a 1-D uint8 tensor of any size):
    one row of crc32_rows. Returns a 0-d int64 tensor on the data's
    device."""
    return crc32_rows(data[None], int(length), int(start))[0]


def crc32(data: torch.Tensor, length: int | None = None, start: int = 0):
    """CRC-32 (zlib/gzip polynomial) of data[start:length] (a uint8
    tensor), on the data's device. Returns a 0-d int64 tensor there."""
    data = torch.as_tensor(data, dtype=torch.uint8)
    return _crc32_impl(data, data.shape[0] if length is None else length,
                       start)


def _adler32_impl(data: torch.Tensor, length: int, start: int = 0,
                  block: int = _BLOCK):
    """Adler-32 of data[start:length] (a 1-D uint8 tensor of any size):
    one row of adler32_rows. ``block`` is the reference's level-0 block;
    the value does not depend on it, and both versions here fix their own
    (the plain version's tree ``ADLER_BLOCK``, the kernel's segments)."""
    del block
    return adler32_rows(data[None], int(length), int(start))[0]


def adler32(data: torch.Tensor, length: int | None = None, start: int = 0):
    """Adler-32 of data[start:length] (a uint8 tensor), on the data's
    device. Returns a 0-d int64 tensor there."""
    data = torch.as_tensor(data, dtype=torch.uint8)
    return _adler32_impl(data, data.shape[0] if length is None else length,
                         start)
