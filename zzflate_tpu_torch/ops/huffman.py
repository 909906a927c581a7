"""Masked symbol histograms (port of ``zzflate_tpu/ops/huffman.py:220-231``).

The reference computes a compare + reduce because colliding scatters
serialize on a TPU; on a GPU and a CPU a scatter-add bincount is the
natural form. The counts are equal.
"""
from __future__ import annotations

import torch


def histogram(symbols, valid, n: int):
    """Masked bincount of `symbols` where `valid`, into `n` bins (int32).

    symbols, valid: (B, m). Returns (B, n). Symbols outside [0, n) are not
    counted, as in the reference."""
    ok = valid & (symbols >= 0) & (symbols < n)
    idx = torch.where(ok, symbols, n).long()
    counts = torch.zeros(
        (symbols.shape[0], n + 1), dtype=torch.int32, device=symbols.device
    )
    counts.scatter_add_(1, idx, ok.int())
    return counts[:, :n]
