"""Device choice of the port's entry points: CUDA unless the caller asks
for the CPU, and never a quiet fall back to the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises ``RuntimeError`` for a CUDA device
    when CUDA is not available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return device
