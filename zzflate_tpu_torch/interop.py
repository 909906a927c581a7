"""Carrying the reference's state into the port.

A codec has no weights: what crosses over from the JAX package is its
level table, its intermediate arrays and its host plans, so that each
stage of the port can be fed the reference's inputs and tested alone.
Arrays cross as numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from zzflate_tpu_torch.config import LevelParams

# Phase-1 keys and the port's dtype for each.
_ANALYSIS_DTYPES = {
    "freq_ll": torch.int32,
    "freq_d": torch.int32,
    "freqs": torch.int32,
    "committed": torch.bool,
    "is_match": torch.bool,
    "litlen_sym": torch.int32,
    "lcode": torch.int32,
    "dcode": torch.int32,
    "mlen": torch.int32,
    "mdist": torch.int32,
}

# Host-plan keys and the port's dtype (u32 codes ride as int64).
_PLAN_DTYPES = {
    "ll_len": torch.int32,
    "ll_code": torch.int64,
    "d_len": torch.int32,
    "d_code": torch.int64,
    "hdr_vals": torch.int64,
    "hdr_nbits": torch.int32,
    "eob_v": torch.int64,
    "eob_nb": torch.int32,
}


def level_params_from_dict(d: dict) -> LevelParams:
    """LevelParams from a dict of its fields (e.g. dataclasses.asdict of
    the reference's LevelParams); unknown or missing fields raise."""
    names = {f.name for f in dataclasses.fields(LevelParams)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown LevelParams fields: {sorted(unknown)}")
    return LevelParams(**d)


def analysis_from_numpy(d: dict, device) -> dict:
    """A phase-1 dict of numpy arrays -> the port's tensors on `device`.
    Keys the port does not use are left out."""
    return {
        k: torch.tensor(np.asarray(d[k]), dtype=dt, device=device)
        for k, dt in _ANALYSIS_DTYPES.items()
        if k in d
    }


def plan_stack(plans: list, device) -> dict:
    """Stack per-chunk host plans (huffman_host.build_chunk_plan) into
    (B, SB, ...) tensors on `device`, as emit_chunks_batch takes them."""
    return {
        k: torch.as_tensor(
            np.stack([np.asarray(p[k]) for p in plans]).astype(np.int64)
        ).to(device=device, dtype=dt)
        for k, dt in _PLAN_DTYPES.items()
    }
