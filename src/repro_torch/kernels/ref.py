"""Plain PyTorch oracles for the port's kernels (counterpart of
``repro.kernels.ref``).

The kernels operate on *pre-quantized integer-valued* tensors (quantization
scales are applied by the ``ops.py`` wrappers), so the oracle contracts are
exact integer/fixed-point math with no RNG:

  * ``adc_quant_ref``       — ideal B-bit staircase over a voltage tile.
  * ``cim_matmul_ref``      — tiled CiM matmul, ``fake_quant`` or ``bitplane``
                              semantics with an ideal (noiseless) ADC.
  * ``flash_attention_ref`` — plain softmax attention (GQA), fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cim_array import plane_weights
from repro_torch.device import divisor

__all__ = ["adc_quant_ref", "cim_matmul_ref", "fake_quant_step", "flash_attention_ref"]


def adc_quant_ref(v: torch.Tensor, bits: int, vdd: float = 1.0) -> torch.Tensor:
    """Ideal mid-tread ADC + mid-point reconstruction: v -> v_hat."""
    n = 1 << bits
    codes = torch.clamp(torch.floor(v / divisor(vdd, v) * n), 0, n - 1)
    return (codes + 0.5) * (vdd / n)


def fake_quant_step(
    rows: int, adc_bits: int, a_bits: int, w_bits: int, a_signed: bool, w_signed: bool
) -> float:
    """RMS-equivalent composite quantizer step, in float64 on the host (the
    kernels round it once to float32)."""
    wa = plane_weights(a_bits, a_signed)
    ww = plane_weights(w_bits, w_signed)
    rms = float(np.sqrt((wa**2).sum()) * np.sqrt((ww**2).sum()))
    return (rows / (1 << adc_bits)) * rms


def cim_matmul_ref(
    x_int: torch.Tensor,  # (M, K) float32, integer-valued
    w_int: torch.Tensor,  # (K, N) float32, integer-valued
    *,
    rows: int = 128,
    adc_bits: int = 8,
    mode: str = "fake_quant",
    a_bits: int = 8,
    w_bits: int = 8,
    a_signed: bool = True,
    w_signed: bool = True,
    exact_counts: bool = False,
) -> torch.Tensor:
    """Oracle for the fused CiM matmul kernel. K must divide by ``rows``."""
    m, k = x_int.shape
    n = w_int.shape[1]
    if k % rows:
        raise ValueError("the wrapper pads K to a multiple of rows")
    t = k // rows

    if mode == "fake_quant":
        xt = x_int.float().reshape(m, t, rows)
        wt = w_int.float().reshape(t, rows, n)
        partial = torch.einsum("mtr,trn->mtn", xt, wt)
        step = fake_quant_step(rows, adc_bits, a_bits, w_bits, a_signed, w_signed)
        step_t = divisor(step, partial)
        return (torch.round(partial / step_t) * step_t).sum(dim=1)

    if mode == "bitplane":
        n_codes = 1 << adc_bits
        wa = plane_weights(a_bits, a_signed)
        ww = plane_weights(w_bits, w_signed)
        xi = x_int.to(torch.int32)
        wi = w_int.to(torch.int32)
        if a_signed:
            xi = torch.where(xi < 0, xi + (1 << a_bits), xi)
        if w_signed:
            wi = torch.where(wi < 0, wi + (1 << w_bits), wi)
        y = torch.zeros((m, n), dtype=torch.float32, device=x_int.device)
        for a in range(a_bits):
            xp = ((xi >> a) & 1).float().reshape(m, t, rows)
            for b in range(w_bits):
                wp = ((wi >> b) & 1).float().reshape(t, rows, n)
                mav = torch.einsum("mtr,trn->mtn", xp, wp) / divisor(rows, xp)
                codes = torch.clamp(torch.floor(mav * n_codes), 0, n_codes - 1)
                counts = codes / n_codes * rows  # floor reconstruction
                if exact_counts:
                    counts = torch.round(counts)
                y = y + float(wa[a] * ww[b]) * counts.sum(dim=1)
        return y

    raise ValueError(f"unknown mode {mode!r}")


def flash_attention_ref(q, k, v, *, causal=True, sm_scale=None):
    """Plain softmax attention oracle (GQA): q (B,H,Sq,hd), k/v (B,KV,Sk,hd)."""
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    if sm_scale is None:
        sm_scale = hd ** -0.5
    qf = q.float().reshape(b, kv, g, sq, hd) * sm_scale
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kf)
    if causal:
        mask = torch.arange(sk, device=q.device)[None, :] <= torch.arange(sq, device=q.device)[:, None]
        s = torch.where(mask[None, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bkcd->bkgqd", p, vf)
    return o.reshape(b, h, sq, hd).to(q.dtype)
