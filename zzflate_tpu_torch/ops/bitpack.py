"""LSB-first bitstream packing as a prefix sum + scatter-add (batched).

Port of ``zzflate_tpu/ops/bitpack.py:81-136``. Fields land at absolute bit
offsets of a little-endian u32 word buffer; a field spans at most two
(scatter_fields) or three (scatter_field48) words. u32 words are carried
as int64 masked to 32 bits, and the bit ranges of distinct fields are
disjoint, so an int64 scatter-add equals the bitwise or.

``words`` is a (B, W + DROP) int64 buffer whose last DROP columns absorb
the updates that fall past the W real words (the reference's
``mode="drop"``); the caller slices them off. The other arrays are (B, F).
"""
from __future__ import annotations

import torch

U32 = 0xFFFFFFFF
DROP = 3  # trash columns: a 48-bit field past the end touches at most 3


def _add(words, idx, vals):
    words.scatter_add_(1, idx.clamp(0, words.shape[1] - 1), vals)


def scatter_fields(words, offsets, values, nbits):
    """Add fields of up to 31 bits at absolute bit offsets (in place)."""
    nbits = nbits.long()
    values = values.long() & ((1 << nbits) - 1) & U32
    offsets = offsets.long()
    word_idx = offsets >> 5
    b = offsets & 31
    _add(words, word_idx, (values << b) & U32)
    _add(words, word_idx + 1, values >> (32 - b))
    return words


def scatter_field48(words, offsets, lo, hi):
    """Add fields of up to 48 bits, pre-split into lo (32) and hi (16)
    bits and already masked to their width, at absolute bit offsets
    (in place)."""
    lo = lo.long() & U32
    hi = hi.long() & U32
    offsets = offsets.long()
    word_idx = offsets >> 5
    b = offsets & 31
    _add(words, word_idx, (lo << b) & U32)
    _add(words, word_idx + 1, ((lo >> (32 - b)) | (hi << b)) & U32)
    _add(words, word_idx + 2, hi >> (32 - b))
    return words
