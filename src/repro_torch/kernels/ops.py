"""Public wrappers of the port's kernels: quantization, padding, scale
handling and reshape (counterpart of ``repro.kernels.ops``).

``cim_matmul_op(x, w, ...)`` is the accelerated counterpart of
``core.cim_linear.cim_matmul`` with an ideal (noiseless) ADC: on CUDA tensors
it runs the fake-quant or the bit-plane CUDA kernel, on CPU tensors the
kernel's plain version. Under ``repro_torch.obs`` tracing it records one
``cim.quantize`` span per operand (everything that turns the float operand
into the kernel's codes; attributes ``operand``, ``bytes`` of the float
operand) and one ``cim.matmul`` span (the kernel and the rescale; ``m``,
``k``, ``n``). ``adc_quant_op(v, ...)`` digitizes and reconstructs a 2-D
tile of analog values with the ideal-ADC kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core.cim_linear import CiMConfig, _fq_operand, _fq_product, _pad_k, quantize_symmetric
from repro_torch.kernels.adc_quant import adc_quant
from repro_torch.kernels.cim_matmul import cim_matmul_bp
from repro_torch.obs import trace as obs_trace

__all__ = ["cim_matmul_op", "adc_quant_op"]


def _bit_patterns(v_int: torch.Tensor, bits: int, signed: bool) -> torch.Tensor:
    """Two's-complement bit patterns of integer-valued ``v_int`` over ``bits``
    bits (plane ``p`` is bit ``p``): uint8 on CUDA, where the kernel takes at
    most 8 planes, int32 on the CPU."""
    p = v_int.to(torch.int32)
    if signed:
        p = torch.where(p < 0, p + (1 << bits), p)
    if p.is_cuda:
        if bits > 8:
            raise ValueError(f"the CUDA bit-plane kernel takes uint8 operands; {bits} bits exceed 8")
        p = p.to(torch.uint8)
    return p


def _plane_operand(v_int: torch.Tensor, bits: int, signed: bool, rows: int, k_dim: int) -> torch.Tensor:
    """An integer-valued operand as the bit-plane kernel takes it: its bit
    patterns, the reduction dim ``k_dim`` (-1 for x, 0 for w) padded to
    whole tiles, contiguous."""
    return _pad_k(_bit_patterns(v_int, bits, signed), rows, k_dim).contiguous()


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
    """CiM-quantized ``x @ w``. K is padded to a multiple of ``rows`` only
    (zero tiles digitize to code 0, as the JAX wrapper's padding to its K
    block does)."""
    if mode not in ("fake_quant", "bitplane"):
        raise ValueError(f"unknown mode {mode!r}")
    batch_shape = x.shape[:-1]
    k = x.shape[-1]
    n = w.shape[1]
    fq = mode == "fake_quant"
    cfg = CiMConfig(
        mode="fake_quant", a_bits=a_bits, w_bits=w_bits, adc_bits=adc_bits,
        rows=rows, a_signed=a_signed, w_signed=w_signed, ste=False,
    ) if fq else None
    traced = obs_trace.enabled()
    with obs_trace.span("cim.quantize", operand="x") as sp:
        xm = x.reshape(-1, k)
        if traced:
            sp.set(bytes=xm.numel() * xm.element_size())
        x_int, sx = quantize_symmetric(xm, a_bits, a_signed)
        x_c = _fq_operand(x_int, cfg, -1) if fq else _plane_operand(x_int, a_bits, a_signed, rows, -1)
    with obs_trace.span("cim.quantize", operand="w") as sp:
        if traced:
            sp.set(bytes=w.numel() * w.element_size())
        w_int, sw = quantize_symmetric(w, w_bits, w_signed, per_axis=-1)
        w_c = _fq_operand(w_int, cfg, 0) if fq else _plane_operand(w_int, w_bits, w_signed, rows, 0)
    with obs_trace.span("cim.matmul", m=xm.shape[0], k=k, n=n):
        if fq:
            y, _ = _fq_product(x_c, w_c, cfg)
        else:
            y = cim_matmul_bp(
                x_c, w_c, rows=rows, adc_bits=adc_bits,
                a_bits=a_bits, w_bits=w_bits, a_signed=a_signed, w_signed=w_signed,
            )
        y = y * sx * sw
    return y.reshape(*batch_shape, n)


def adc_quant_op(v: torch.Tensor, *, bits: int = 5, vdd: float = 1.0) -> torch.Tensor:
    """Ideal-ADC quantize + reconstruct of a 2-D analog-value array (float32
    out). On CUDA ``v`` must be float32; the kernel masks its ragged edge
    itself, so nothing is padded."""
    if v.dim() != 2:
        raise ValueError(f"adc_quant_op takes a 2-D array, got shape {tuple(v.shape)}")
    return adc_quant(v.contiguous(), bits=bits, vdd=vdd).float()
