"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. A missing
GPU is an error, never a silent CPU fallback: a run that asked for the card
and got the CPU would report CPU numbers as if they were the card's.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and none exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
