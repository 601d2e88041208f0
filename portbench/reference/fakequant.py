"""The CiM fake-quant linear in plain PyTorch (float32, TF32 off).

A frozen copy of the arithmetic of ``core/cim_linear.py``,
``kernels/ops.py`` and the plain version of ``kernels/cim_matmul.py`` in
``src/repro_torch``: the activation is quantized per call over the whole
batch (one symmetric scale, computed at the activation's precision), the
float32 weight per output column; each reduction tile of ``rows`` products
is an exact integer sum, quantized with the RMS-equivalent composite step
``round(p / step) * step``; the tiles are summed and rescaled.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fake_quant_step", "quantize", "FakeQuantLinear"]


def _plane_weights(bits: int, signed: bool) -> np.ndarray:
    w = 2.0 ** np.arange(bits)
    if signed:
        w[-1] = -w[-1]
    return w


def fake_quant_step(rows: int, adc_bits: int, a_bits: int, w_bits: int, a_signed: bool, w_signed: bool) -> float:
    """The composite quantizer's step, in float64 (used as float32)."""
    wa, ww = _plane_weights(a_bits, a_signed), _plane_weights(w_bits, w_signed)
    return (rows / (1 << adc_bits)) * float(np.sqrt((wa ** 2).sum()) * np.sqrt((ww ** 2).sum()))


def quantize(x: torch.Tensor, bits: int, signed: bool, rnd, per_column: bool = False, rnd_scale=None):
    """Symmetric quantization of float32 ``x``, every result rounded by
    ``rnd`` (the precision the values are held in; the scale by
    ``rnd_scale``, ``rnd`` by default): ``(codes, scale)``, the codes float32
    integers, rounded half to even."""
    rnd_scale = rnd if rnd_scale is None else rnd_scale
    mag = x.abs() if signed else torch.clamp(x, min=0)
    absmax = torch.amax(mag, dim=0, keepdim=True) if per_column else torch.amax(mag)
    qmax = (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1
    q = torch.full((), float(qmax), device=x.device)
    scale = torch.where(absmax > 0, rnd_scale(absmax / q), torch.ones_like(absmax))
    lo = -qmax - 1 if signed else 0
    return torch.clamp(torch.round(rnd(x / scale)), lo, qmax), scale


class FakeQuantLinear:
    """``y = x @ w`` through the fake-quant CiM pipeline. The weights' codes
    and scales depend on the weights alone and are kept per weight; the
    activation's are worked out at every call, as the program does."""

    def __init__(self, cim: dict, block_bytes: int = 4 << 30):
        if cim["mode"] != "fake_quant":
            raise ValueError(f"the reference has no CiM mode {cim['mode']!r}")
        self.cim = cim
        self.rows = cim["rows"]
        self.step = fake_quant_step(cim["rows"], cim["adc_bits"], cim["a_bits"], cim["w_bits"],
                                    cim["a_signed"], cim["w_signed"])
        self.block_bytes = block_bytes
        self._w: dict = {}

    def _weight(self, w: torch.Tensor):
        key = (w.data_ptr(), tuple(w.shape))
        if key not in self._w:
            codes, scale = quantize(w.float(), self.cim["w_bits"], self.cim["w_signed"], lambda t: t, per_column=True)
            k, n = codes.shape
            self._w[key] = (codes.view(k // self.rows, self.rows, n), scale)
        return self._w[key]

    def __call__(self, x: torch.Tensor, w: torch.Tensor, rnd, rnd_scale=None) -> torch.Tensor:
        """x (..., K) float32 holding values of the activation precision;
        w (K, N). Returns rnd(y) (..., N)."""
        lead, k = x.shape[:-1], x.shape[-1]
        if k % self.rows:
            raise ValueError(f"K={k} is not a multiple of rows={self.rows}")
        xm = x.reshape(-1, k)
        x_int, sx = quantize(xm, self.cim["a_bits"], self.cim["a_signed"], rnd, rnd_scale=rnd_scale)
        wt, sw = self._weight(w)
        t, _, n = wt.shape
        step = torch.full((), self.step, device=x.device)  # a true divide by it, as the program's
        y = torch.empty((xm.shape[0], n), device=x.device)
        rows = max(1, self.block_bytes // (4 * t * n))
        for i in range(0, xm.shape[0], rows):
            xb = x_int[i:i + rows].view(-1, t, self.rows).transpose(0, 1)
            p = torch.bmm(xb, wt)  # (T, rows, N): every tile's exact integer sum
            y[i:i + rows] = p.div_(step).round_().sum(dim=0)
        # the sum of the tiles' q * step: equal to the program's while it is exact in float32
        y = y.mul_(step) * sx * sw
        return rnd(y).reshape(*lead, n)
