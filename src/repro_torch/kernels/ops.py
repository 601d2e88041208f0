"""Public wrappers of the port's kernels: quantization, padding, scale
handling and reshape (counterpart of ``repro.kernels.ops``).

``cim_matmul_op(x, w, ...)`` is the accelerated counterpart of
``core.cim_linear.cim_matmul`` with an ideal (noiseless) ADC: on CUDA tensors
it runs the fake-quant CUDA kernel on int8 operands, on CPU tensors the
kernel's plain version.
"""

from __future__ import annotations

import torch

from repro_torch.core.cim_linear import CiMConfig, _fake_quant_matmul, quantize_symmetric

__all__ = ["cim_matmul_op"]


def cim_matmul_op(
    x: torch.Tensor,  # (..., K) float
    w: torch.Tensor,  # (K, N) float
    *,
    rows: int = 128,
    adc_bits: int = 8,
    mode: str = "fake_quant",
    a_bits: int = 8,
    w_bits: int = 8,
    a_signed: bool = True,
    w_signed: bool = True,
) -> torch.Tensor:
    """CiM-quantized ``x @ w``. K is padded to a multiple of ``rows`` only."""
    if mode != "fake_quant":
        raise NotImplementedError(
            f"cim_matmul_op mode {mode!r}: the bitplane kernel is not ported yet "
            f"(ROADMAP.md, port queue B)"
        )
    batch_shape = x.shape[:-1]
    k = x.shape[-1]
    n = w.shape[1]
    xm = x.reshape(-1, k)
    x_int, sx = quantize_symmetric(xm, a_bits, a_signed)
    w_int, sw = quantize_symmetric(w, w_bits, w_signed, per_axis=-1)
    cfg = CiMConfig(
        mode="fake_quant", a_bits=a_bits, w_bits=w_bits, adc_bits=adc_bits,
        rows=rows, a_signed=a_signed, w_signed=w_signed, ste=False,
    )
    y, _ = _fake_quant_matmul(x_int, w_int, cfg)
    y = y * sx * sw
    return y.reshape(*batch_shape, n)
