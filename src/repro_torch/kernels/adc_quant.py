"""Ideal ADC quantize + reconstruct: the hand-written CUDA kernel and its plain
version.

The PyTorch/CUDA counterpart of the Pallas kernel
``repro.kernels.cim_matmul._adc_quant_kernel``: every analog value is
digitized by an ideal B-bit ADC, ``codes = clip(floor(v / vdd * 2^B), 0,
2^B - 1)``, and reconstructed at the bin's mid-point,
``(codes + 0.5) * (vdd / 2^B)``.

:func:`adc_quant` runs the CUDA kernel (``csrc/adc_quant.cu``) on CUDA tensors
and :func:`adc_quant_plain` on CPU tensors; it never falls back from one to
the other. The kernel streams 16-byte float4s and takes any contiguous float32
tensor, whatever its length or its start's alignment. ``launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch import work

__all__ = ["adc_quant", "adc_quant_plain", "launches"]

launches = 0  # kernel launches by adc_quant (plain CPU calls do not count)


def adc_quant_plain(v: torch.Tensor, *, bits: int, vdd: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version: ``ref.adc_quant_ref`` (a true IEEE divide by
    ``vdd`` on every device), elementwise over ``v``."""
    return ref.adc_quant_ref(v, bits, vdd)


@work.kernel("adc_quant", lambda v, **_: (0.0, 5.0 * v.numel(), 8 * v.numel()))
def adc_quant(v: torch.Tensor, *, bits: int, vdd: float = 1.0) -> torch.Tensor:
    """Ideal ADC quantize + reconstruct of the analog values ``v``.

    CPU tensors take the plain version. CUDA tensors must be contiguous
    float32 and launch the kernel (float32 out, ``v``'s shape)."""
    if v.device.type == "cpu":
        return adc_quant_plain(v, bits=bits, vdd=vdd)
    return _launch(v, bits, vdd)


def _lib():
    lib = build.load("adc_quant")
    fn = lib.adc_quant
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(v: torch.Tensor, bits: int, vdd: float) -> torch.Tensor:
    global launches
    if v.device.type != "cuda":
        raise ValueError(
            f"adc_quant: a tensor on {v.device}; the kernel takes a tensor on a CUDA "
            f"device (CPU tensors take the plain version)"
        )
    if v.dtype != torch.float32:
        raise TypeError(f"adc_quant: the kernel takes float32, got {v.dtype}")
    if not v.is_contiguous():
        raise ValueError("adc_quant: the input must be contiguous")
    if not 1 <= bits <= 24:
        raise ValueError(f"adc_quant: the kernel takes 1..24 bits, got {bits}")
    if v.numel() == 0:
        return torch.empty_like(v)
    # the kernel moves float4s through one index for v and out, so out gets
    # v's address modulo 16 bytes: a fresh tensor (allocations are aligned),
    # or for a misaligned v a view a few floats into its own buffer
    lead = v.data_ptr() % 16 // 4
    if lead:
        out = torch.empty(v.numel() + lead, dtype=v.dtype, device=v.device)[lead:].view(v.shape)
    else:
        out = torch.empty_like(v)
    # vdd / 2^B rounded once to float32, as JAX rounds the Python float vdd / n
    err = _lib()(
        v.data_ptr(), out.data_ptr(), v.numel(), bits, vdd, vdd / (1 << bits),
        torch.cuda.current_stream(v.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"adc_quant: kernel launch failed with CUDA error {err}")
    launches += 1
    return out
