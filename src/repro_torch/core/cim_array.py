"""Bit-plane helpers of the 8T compute-in-SRAM array model (paper Fig. 2).

Signed multibit operands use two's-complement bit planes recombined digitally
with signed powers of two (the MSB plane carries weight ``-2^(n-1)``). The
PyTorch counterpart of ``repro.core.cim_array``'s ``bit_planes`` and
``plane_weights``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bit_planes", "plane_weights"]


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
