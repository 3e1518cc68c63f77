"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; with
no card and no explicit `device="cpu"` they raise instead of carrying
on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`None` means `cuda`; a CUDA device with no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def name(dev: torch.device) -> str:
    """What a measurement ran on: the card's name, or "cpu"."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
