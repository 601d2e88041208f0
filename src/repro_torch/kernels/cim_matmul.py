"""CiM fake-quant matmul: the hand-written CUDA kernel and its plain version.

The PyTorch/CUDA counterpart of the Pallas kernel
``repro.kernels.cim_matmul._cim_matmul_kernel_fakequant``: the reduction
dimension is tiled into ``rows``-sized "CiM arrays"; each tile's exact integer
partial product-sum is quantized with the RMS-equivalent composite step,
``round_half_even(partial / step) * step``, and the tiles are summed.

:func:`cim_matmul_fq` runs the CUDA kernel (``csrc/cim_matmul_fq.cu``) on CUDA
tensors and :func:`cim_matmul_fq_plain` on CPU tensors; it never falls back
from one to the other. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

__all__ = ["cim_matmul_fq", "cim_matmul_fq_plain", "launches"]

launches = 0  # kernel launches by cim_matmul_fq (plain CPU calls do not count)


def cim_matmul_fq_plain(
    x_int: torch.Tensor, w_int: torch.Tensor, *, rows: int, step: float
) -> torch.Tensor:
    """Plain PyTorch version: x_int (M, K) @ w_int (K, N), integer-valued,
    K a multiple of ``rows``; float32 (M, N)."""
    m, k = x_int.shape
    n = w_int.shape[1]
    if k % rows:
        raise ValueError(f"K={k} is not a multiple of rows={rows}; pad it first")
    t = k // rows
    partial = torch.einsum(
        "mtr,trn->mtn", x_int.float().reshape(m, t, rows), w_int.float().reshape(t, rows, n)
    )
    # a tensor divisor keeps the division a true IEEE divide on every device
    step_t = torch.tensor(step, dtype=torch.float32, device=partial.device)
    return (torch.round(partial / step_t) * step_t).sum(dim=1)


def cim_matmul_fq(
    x_int: torch.Tensor, w_int: torch.Tensor, *, rows: int, step: float
) -> torch.Tensor:
    """CiM fake-quant matmul of integer-valued ``x_int`` (M, K) and
    ``w_int`` (K, N), K a multiple of ``rows``; returns float32 (M, N).

    CPU tensors take the plain version. CUDA tensors must be contiguous int8
    on one device, and launch the kernel."""
    if x_int.device.type == "cpu" and w_int.device.type == "cpu":
        return cim_matmul_fq_plain(x_int, w_int, rows=rows, step=step)
    return _launch(x_int, w_int, rows, step)


def _lib():
    lib = build.load("cim_matmul_fq")
    fn = lib.cim_matmul_fq
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, w: torch.Tensor, rows: int, step: float) -> torch.Tensor:
    global launches
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"cim_matmul_fq: operands on {x.device} and {w.device}; the kernel "
            f"takes two tensors on one CUDA device (CPU tensors take the plain version)"
        )
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"cim_matmul_fq: the kernel takes int8 operands, got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"cim_matmul_fq: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("cim_matmul_fq: operands must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    if m == 0 or n == 0 or k == 0 or k % rows:
        raise ValueError(f"cim_matmul_fq: M={m}, N={n}, K={k} (K a multiple of rows={rows})")
    t = k // rows
    rows4 = -(-rows // 4) * 4  # a tile padded to whole int32 words
    xp = x.reshape(m, t, rows)
    wp = w.t().reshape(n, t, rows)  # K contiguous for both operands
    if rows4 != rows:
        xp = F.pad(xp, (0, rows4 - rows))
        wp = F.pad(wp, (0, rows4 - rows))
    kw = t * rows4 // 4
    xw = xp.contiguous().reshape(m, t * rows4).view(torch.int32)
    ww = wp.contiguous().reshape(n, t * rows4).view(torch.int32)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = _lib()(
        xw.data_ptr(), ww.data_ptr(), out.data_ptr(), m, n, kw, rows4 // 4,
        step, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"cim_matmul_fq: kernel launch failed with CUDA error {err}")
    launches += 1
    return out
