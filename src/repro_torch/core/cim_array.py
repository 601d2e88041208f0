"""Bit-plane helpers of the 8T compute-in-SRAM array model (paper Fig. 2).

Signed multibit operands use two's-complement bit planes recombined digitally
with signed powers of two (the MSB plane carries weight ``-2^(n-1)``). The
PyTorch counterpart of ``repro.core.cim_array``'s ``bit_planes``,
``plane_weights`` and ``from_bit_planes``. ``CiMArrayModel`` (analog MAV noise
from a ``jax.random`` key) waits for the PRNG port (ROADMAP.md, port queue A1).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bit_planes", "plane_weights", "from_bit_planes"]


def bit_planes(x_int: torch.Tensor, bits: int, signed: bool) -> torch.Tensor:
    """Decompose integers into bit planes, LSB first: output (bits, *x.shape)
    int32. Signed inputs are read in two's complement over ``bits`` bits."""
    x = x_int.to(torch.int32)
    if signed:
        x = torch.where(x < 0, x + (1 << bits), x)
    shifts = torch.arange(bits, dtype=torch.int32, device=x.device)
    shifts = shifts.reshape((bits,) + (1,) * x.dim())
    return (x[None] >> shifts) & 1


def plane_weights(bits: int, signed: bool) -> np.ndarray:
    """Digital recombination weight of each plane (LSB first), float64."""
    w = 2.0 ** np.arange(bits)
    if signed:
        w[-1] = -w[-1]
    return w


def from_bit_planes(planes: torch.Tensor, bits: int, signed: bool) -> torch.Tensor:
    """Inverse of :func:`bit_planes` (for tests): int32 (*planes.shape[1:])."""
    w = torch.as_tensor(plane_weights(bits, signed), dtype=torch.float32, device=planes.device)
    w = w.reshape((bits,) + (1,) * (planes.dim() - 1))
    return (planes * w).sum(dim=0).to(torch.int32)
