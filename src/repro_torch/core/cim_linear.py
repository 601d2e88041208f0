"""CiM-quantized matmul / linear layer — the paper's technique as a PyTorch op.

The PyTorch counterpart of ``repro.core.cim_linear``. A matmul ``y = x @ w`` is
mapped onto bit-plane compute-in-SRAM arrays: the reduction dimension K is
split into tiles of ``rows`` (one CiM array's word lines each),
activations/weights are quantized to ``a_bits``/``w_bits``, and every tile's
product-sum is digitized before the tiles are accumulated.

Modes ported so far:

  * ``exact``      — plain matmul (no CiM).
  * ``fake_quant`` — integer per-tile partial sums passed through the
                     RMS-equivalent composite quantizer. On a CUDA tensor this
                     runs the hand-written fake-quant kernel
                     (``repro_torch.kernels.cim_matmul``), on a CPU tensor its
                     plain PyTorch version.

``bitplane`` and ``int8_dot`` are not ported yet (ROADMAP.md, queue A) and
raise ``NotImplementedError``. ``ste=True`` wraps the quantized output in a
straight-through estimator (``detach``) so the op is trainable.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

__all__ = ["CiMConfig", "CimStats", "cim_matmul", "cim_linear", "quantize_symmetric"]


@dataclasses.dataclass(frozen=True)
class CiMConfig:
    """Static configuration of the CiM mapping for one linear layer."""

    mode: str = "fake_quant"  # exact | fake_quant | bitplane | int8_dot
    a_bits: int = 8
    w_bits: int = 8
    adc_bits: int = 5
    rows: int = 16  # word lines per CiM array (reduction-tile size)
    a_signed: bool = True  # post-ReLU activations may use unsigned planes
    w_signed: bool = True
    search: str = "sar"  # sar | sar_asym — affects cost accounting (+codes under noise)
    comparator_sigma: float = 0.0
    ref_mismatch_sigma: float = 0.0
    ste: bool = True  # straight-through estimator (QAT)
    exact_counts: bool = False  # round reconstructed counts to integers

    def __post_init__(self):
        if self.mode not in ("exact", "fake_quant", "bitplane", "int8_dot"):
            raise ValueError(f"unknown CiM mode {self.mode!r}")


class CimStats(NamedTuple):
    conversions: torch.Tensor  # total ADC conversions performed
    comparisons: torch.Tensor  # total comparator firings (energy proxy)


def quantize_symmetric(
    x: torch.Tensor, bits: int, signed: bool, per_axis: Optional[int] = None
):
    """Uniform symmetric quantization, computed in ``x``'s dtype.

    Returns ``(x_int, scale)``: ``x_int`` integer-valued in ``x``'s dtype,
    rounded half to even as ``jnp.round`` does.
    """
    mag = x.abs() if signed else torch.clamp(x, min=0)
    if per_axis is not None:
        red = tuple(i for i in range(x.dim()) if i != per_axis % x.dim())
        absmax = torch.amax(mag, dim=red, keepdim=True)
    else:
        absmax = torch.amax(mag)
    qmax = (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    lo = -qmax - 1 if signed else 0
    x_int = torch.clamp(torch.round(x / scale), lo, qmax)
    return x_int, scale


def _pad_reduction(x_int, w_int, rows):
    k = x_int.shape[-1]
    pad = (-k) % rows
    if pad:
        x_int = F.pad(x_int, (0, pad))
        w_int = F.pad(w_int, (0, 0, 0, pad))
    return x_int, w_int, (k + pad) // rows


def _fake_quant_matmul(x_int, w_int, cfg: CiMConfig):
    """Integer per-tile partial sums + RMS-equivalent composite quantizer.

    Each plane-pair's count is independently quantized with step R/2^B; the
    equivalent single quantizer on the composite tile partial sum uses the
    RMS combination of the plane recombination weights. On CUDA the operands
    go to the kernel as int8, so both widths must be at most 8 bits.
    Returns ``(y_int float32 (M, N), step)``.
    """
    from repro_torch.kernels.cim_matmul import cim_matmul_fq
    from repro_torch.kernels.ref import fake_quant_step

    r = cfg.rows
    x_int, w_int, _ = _pad_reduction(x_int, w_int, r)
    step = fake_quant_step(r, cfg.adc_bits, cfg.a_bits, cfg.w_bits, cfg.a_signed, cfg.w_signed)
    if x_int.is_cuda:
        if cfg.a_bits > 8 or cfg.w_bits > 8:
            raise ValueError(
                f"the CUDA fake-quant kernel takes int8 operands; "
                f"a_bits={cfg.a_bits}, w_bits={cfg.w_bits} exceed 8"
            )
        x_int, w_int = x_int.to(torch.int8), w_int.to(torch.int8)
    return cim_matmul_fq(x_int, w_int, rows=r, step=step), step


def _not_ported(mode: str):
    return NotImplementedError(
        f"CiM mode {mode!r} is not ported to PyTorch yet "
        f"(ROADMAP.md, port queue A: core/cim_linear bitplane and int8_dot)"
    )


def cim_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg: CiMConfig,
    key=None,
    return_stats: bool = False,
):
    """``y = x @ w`` through the CiM pipeline.

    ``x``: (..., K); ``w``: (K, N). Leading dims of x are flattened. ``key``
    (ADC noise) belongs to the modes that are not ported yet and must be None.
    """
    if cfg.mode in ("bitplane", "int8_dot"):
        raise _not_ported(cfg.mode)
    if key is not None:
        raise _not_ported("noisy ADC")
    if cfg.mode == "exact":
        y = x @ w
    else:
        from repro_torch.kernels.ops import cim_matmul_op

        y = cim_matmul_op(
            x, w, rows=cfg.rows, adc_bits=cfg.adc_bits, mode="fake_quant",
            a_bits=cfg.a_bits, w_bits=cfg.w_bits,
            a_signed=cfg.a_signed, w_signed=cfg.w_signed,
        )
        if cfg.ste:
            y_lin = x @ w
            y = y_lin + (y - y_lin).detach()
    if return_stats:
        z = torch.zeros((), dtype=torch.int32, device=y.device)
        return y, CimStats(z, z)
    return y


def cim_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    cfg: Optional[CiMConfig] = None,
    key=None,
):
    """Linear layer front-end used by the model zoo."""
    if cfg is None or cfg.mode == "exact":
        y = x @ w
    else:
        y = cim_matmul(x, w, cfg, key=key)
    if bias is not None:
        y = y + bias
    return y
