"""Behavioral model of an 8T bit-plane compute-in-SRAM array (paper Fig. 2).

The array stores 1-bit weight planes down ``rows`` word lines. One 1-bit input
plane is applied per cycle on the input lines (IL); a column line (CL)
discharges only where stored bit AND input bit are both '1'; merging CLs on
the sum lines (SL) charge-averages the column results into the analog
multiply-average voltage ``V_MAV = VDD * (1/R) * sum_r x_r * w_rc``.

Signed multibit operands use two's-complement bit planes recombined digitally
with signed powers of two (the MSB plane carries weight ``-2^(n-1)``). The
PyTorch counterpart of ``repro.core.cim_array``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import divisor

__all__ = ["bit_planes", "plane_weights", "from_bit_planes", "CiMArrayModel"]


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


@dataclasses.dataclass(frozen=True)
class CiMArrayModel:
    """One physical CiM array: geometry + analog non-idealities.

    ``mav_sigma`` is the *residual* relative error of the analog MAV after the
    common-mode cancellation the paper gets from using an identical neighbor
    array for reference generation (§II-A) — small by construction.
    """

    rows: int = 16
    cols: int = 32
    vdd: float = 1.0
    mav_sigma: float = 0.0

    def compute_mav(self, x_bits: torch.Tensor, w_bits: torch.Tensor, key=None) -> torch.Tensor:
        """Analog MAV voltages (..., cols) float32 in [0, VDD] of one input
        plane ``x_bits`` (..., rows) on one stored weight plane ``w_bits``
        (rows, cols), both {0, 1}; with ``mav_sigma > 0`` plus
        ``mav_sigma * vdd * normal(key, shape)`` (a ``core.prng`` key)."""
        if x_bits.shape[-1] != self.rows or tuple(w_bits.shape) != (self.rows, self.cols):
            raise ValueError(
                f"shape mismatch: x{tuple(x_bits.shape)} w{tuple(w_bits.shape)} "
                f"array {self.rows}x{self.cols}"
            )
        mav = x_bits.float() @ w_bits.float()
        v = mav / divisor(self.rows, mav) * self.vdd
        if self.mav_sigma > 0.0:
            if key is None:
                raise ValueError("mav noise requires a PRNG key")
            v = v + self.mav_sigma * self.vdd * prng.normal(prng.as_key(key, v.device), v.shape)
        return v
