"""LR schedules of the PyTorch port (counterpart of ``repro.optim.schedules``):
float32 0-d tensors from an int or tensor step, computed as the JAX package
computes them."""

from __future__ import annotations

import math

import torch

from repro_torch.device import divisor

__all__ = ["warmup_cosine", "warmup_linear"]


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def _warm_and_frac(step, peak_lr: float, warmup: int, total: int):
    warm = peak_lr * torch.clamp(step / divisor(max(warmup, 1), step), max=1.0)
    frac = torch.clamp((step - warmup) / divisor(max(total - warmup, 1), step), 0.0, 1.0)
    return warm, frac


def warmup_cosine(step, peak_lr: float, warmup: int, total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine decay to ``floor * peak_lr``
    at ``total``."""
    step = _step(step)
    warm, frac = _warm_and_frac(step, peak_lr, warmup, total)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def warmup_linear(step, peak_lr: float, warmup: int, total: int) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then linear decay to 0 at ``total``."""
    step = _step(step)
    warm, frac = _warm_and_frac(step, peak_lr, warmup, total)
    return torch.where(step < warmup, warm, peak_lr * (1 - frac))
