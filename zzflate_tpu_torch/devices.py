"""The port's device rule, below every module that takes a ``device``.

``device=None`` means CUDA and raises RuntimeError when no GPU is present;
only an explicit ``device="cpu"`` runs the plain torch versions of the
kernels on the CPU. A distributed job's process takes its own card.
"""
from __future__ import annotations

import os

import torch


def resolve_device(device) -> torch.device:
    """None -> the current CUDA card (RuntimeError without a GPU);
    otherwise as given. A CUDA device always carries its index, so a
    tensor made there compares equal to it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain torch "
                "path on the CPU"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def rank_device(device, rank: int) -> torch.device:
    """The device of one process of a distributed job: as given, or for
    None the process's own card, cuda:(LOCAL_RANK or rank) % the visible
    card count (processes of one host share its cards round-robin);
    RuntimeError without a GPU."""
    dev = resolve_device(device)
    if device is None:
        local = os.environ.get("LOCAL_RANK", "")
        idx = int(local) if local else rank
        dev = torch.device("cuda", idx % torch.cuda.device_count())
    return dev
