"""A threefry-2x32 PRNG that draws what ``jax.random`` draws, bit for bit.

The JAX package's noise (ADC comparator noise, reference-ladder mismatch, MAV
noise) comes from ``jax.random`` keys split and folded per call, per column
tile and per global row. This module is the port's counterpart of the part
of ``jax.random`` the package uses, specified by jax 0.9.0 with
``jax_threefry_partitionable=True`` (``jax/_src/prng.py``: ``threefry_seed``,
``iota_2x32_shape``, ``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``; ``jax/_src/random.py``: ``_uniform``,
``_normal_real``):

* a key is an int64 tensor ``(..., 2)`` holding two uint32 words; leading
  dimensions are a batch of keys, and every function maps over them as
  ``jax.vmap`` would (one key per row of the per-row ADC noise);
* ``PRNGKey(seed)`` is ``(0, seed mod 2^32)``; ``split(key, n)[i]`` and
  ``fold_in(key, i)`` are both ``threefry(key, (0, i))``;
* ``bits(key, shape)`` hashes the 64-bit flat index ``(hi, lo)`` of every
  element and returns the XOR of the two output words;
* ``uniform`` puts 23 random bits under the exponent of 1.0 and scales;
* ``normal`` is ``sqrt(2) * erf_inv(u)`` with ``u`` uniform on
  ``(-1, 1)``, and ``erf_inv`` is XLA's CPU code as compiled: its
  ``log1p`` (a rational function near 0, Cephes' ``logf`` elsewhere) and
  the erf_inv polynomial, with every multiply-add pair that LLVM contracts
  into a fused multiply-add computed as one. ``torch.log1p``,
  ``torch.log`` and ``torch.erfinv`` round differently and do not serve.

The uint32 arithmetic runs in int64 tensors masked to 32 bits, and every
floating-point step is either a correctly rounded float32 operation or an
exactly emulated one (a fused multiply-add, a divide, a square root, through
float64), so a draw is the same on the CPU and on CUDA. Plain PyTorch on
every device: the JAX package has no Pallas kernel here either.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["PRNGKey", "split", "fold_in", "bits", "uniform", "normal", "normal_at", "as_key"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def as_key(key, device=None) -> torch.Tensor:
    """A key (or a batch of keys) as the port holds it: int64 ``(..., 2)``
    of uint32 words. Takes the port's keys, numpy or JAX uint32 key data
    (``jax.random.PRNGKey(0)``), or nested lists."""
    if isinstance(key, torch.Tensor):
        t = key if key.dtype == torch.int64 else key.to(torch.int64)
    else:
        import numpy as np

        t = torch.as_tensor(np.asarray(key).astype(np.int64))
    if t.dim() == 0 or t.shape[-1] != 2:
        raise ValueError(f"a threefry key has shape (..., 2); got {tuple(t.shape)}")
    t = t & _MASK
    return t if device is None else t.to(device)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key ``(0, seed mod 2^32)`` (a seed
    is cut to 32 bits, as JAX does without 64-bit mode).

    The key lies on ``device``, the CPU when None. That default is meant: a
    key is two words, and every function that draws for data moves it to
    the data's device (:func:`as_key`), so the draws land where the data
    does. Only a bare draw (``normal(PRNGKey(0), shape)``) takes the key's
    device, and asks for CUDA with ``PRNGKey(seed, "cuda")``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# The threefry-2x32 block function
# ---------------------------------------------------------------------------


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def _threefry(k1, k2, x0, x1):
    """Threefry-2x32 with 20 rounds on broadcastable int64 uint32 words, as
    ``jax._src.prng._threefry2x32_lowering``. Returns ``(y0, y1)``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + k1) & _MASK
    x1 = (x1 + k2) & _MASK
    x0, x1 = torch.broadcast_tensors(x0, x1)
    x0, x1 = x0.contiguous(), x1.contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            x1 = _rotl(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_MASK)
    return x0, x1


def _key_words(key: torch.Tensor, extra_dims: int):
    """The key's two words, each shaped ``batch + (1,) * extra_dims`` to
    broadcast against per-element counters."""
    shape = key.shape[:-1] + (1,) * extra_dims
    return key[..., 0].reshape(shape), key[..., 1].reshape(shape)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(..., num, 2)``."""
    key = as_key(key)
    k1, k2 = _key_words(key, 1)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = _threefry(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``. ``data`` is an int in
    ``[0, 2^32)`` or an integer tensor of them (a tensor is read modulo
    2^32, as an int32 converted to uint32); a tensor of data folds the
    one key into one key per element, as ``jax.vmap(fold_in, (None, 0))``
    does: ``key.shape[:-1] + data.shape + (2,)``."""
    key = as_key(key)
    if isinstance(data, torch.Tensor):
        d = data.to(device=key.device, dtype=torch.int64) & _MASK
    else:
        if not 0 <= int(data) <= _MASK:
            raise OverflowError(f"Python integer {data} out of bounds for uint32")
        d = torch.tensor(int(data), dtype=torch.int64, device=key.device)
    k1, k2 = _key_words(key, d.dim())
    y0, y1 = _threefry(k1, k2, torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


# ---------------------------------------------------------------------------
# Random bits, uniform and normal draws
# ---------------------------------------------------------------------------


def _bits_at(key: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """32-bit draws of ``key`` at flat element indices ``index`` (int64, any
    shape): ``key.shape[:-1] + index.shape``, each ``y0 ^ y1`` of the
    threefry of the 64-bit index split into (hi, lo) words."""
    k1, k2 = _key_words(key, index.dim())
    y0, y1 = _threefry(k1, k2, index >> 32, index & _MASK)
    return y0.bitwise_xor_(y1)


def _flat_index(shape: Sequence[int], device) -> torch.Tensor:
    return torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(tuple(shape))


def bits(key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 values in int64)."""
    key = as_key(key)
    return _bits_at(key, _flat_index(shape, key.device))


def _f32(pattern: int) -> float:
    import struct

    return struct.unpack("<f", struct.pack("<I", pattern))[0]


def _unit_floats(b: torch.Tensor) -> torch.Tensor:
    """``[0, 1)`` float32 from 32-bit draws: the top 23 bits as the mantissa
    of a float in ``[1, 2)``, less 1 (exact)."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add ``fl32(a * b + c)``, exact on every device.

    The product of two float32 is exact in float64; the sum is taken in
    float64 rounded to odd (the rounding error, found by TwoSum, sets the
    last bit), which then rounds to float32 as the exact sum would. Separate
    float64 operations, so no kernel's own contraction can enter."""
    a64 = a.double()
    p = a64 * (b.double() if isinstance(b, torch.Tensor) else float(b))
    c64 = c.double() if isinstance(c, torch.Tensor) else torch.full_like(a64, float(c))
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    sb = s.view(torch.int64)
    inexact_even = (err != 0) & ((sb & 1) == 0)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    s = torch.where(inexact_even, sb + toward, sb).view(torch.float64)
    return s.float()


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a / b`` (through float64: 53 >= 2*24 + 2
    bits, so the double rounding is exact)."""
    return (a.double() / b.double()).float()


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64, exact as
    ``_div``)."""
    return torch.sqrt(a.double()).float()


def _where_f32(cond, yes: int, no: int) -> torch.Tensor:
    """Per-element float32 constant ``yes`` or ``no`` (bit patterns)."""
    return torch.where(cond, _f32(yes), _f32(no)).float()


def uniform(key, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: float32
    ``key.shape[:-1] + shape``. The scale and shift is one fused
    multiply-add, as XLA compiles it, then clipped below at ``minval``."""
    key = as_key(key)
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    u = _fma(_unit_floats(_bits_at(key, _flat_index(shape, key.device))), span.to(key.device), float(lo))
    return torch.clamp(u, min=float(lo))


def normal(key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(key, shape)``: standard normal float32
    ``key.shape[:-1] + shape``."""
    key = as_key(key)
    return normal_at(key, _flat_index(shape, key.device))


def normal_at(key, index: torch.Tensor) -> torch.Tensor:
    """The draws of ``normal(key, shape)`` at flat element indices ``index``
    (int64 tensor, broadcast against the key's batch: ``key.shape[:-1] +
    index.shape``). A slice of a large draw, such as one step of the ADC's
    comparator noise, costs only its own elements."""
    key = as_key(key)
    lo = _f32(0xBF7FFFFF)  # nextafter(-1, 0): u lies in (-1, 1)
    # u = floats * (1 - lo) + lo; 1 - lo rounds to 2.0, so the product is exact
    u = torch.clamp(_unit_floats(_bits_at(key, index)) * 2.0 + lo, min=lo)
    return _erf_inv(u) * _f32(0x3FB504F3)  # * fl32(sqrt(2))


# ---------------------------------------------------------------------------
# XLA's CPU erf_inv, as compiled (jax 0.9.0, LLVM IR of the fused kernel)
# ---------------------------------------------------------------------------


def _log_big(t: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log of ``t`` (Cephes ``logf``): mantissa ``m`` in
    ``[0.5, 1)`` and exponent ``e``, folded to ``x = m - 1`` or ``2m - 1``
    around sqrt(1/2), an odd polynomial by Estrin's scheme."""
    tm = torch.clamp(t, min=_f32(0x00800000))
    b = tm.view(torch.int32)
    m = ((b & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e0 = ((b >> 23) - 127).float() + 1.0
    small = m < _f32(0x3F3504F3)
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e0 - small.float()
    z = x * x
    x3 = z * x
    p1 = _fma(_fma(x, _f32(0x3D9021BB), _f32(0xBDEBD1B8)), x, _f32(0x3DEF251A))
    p2 = _fma(_fma(x, _f32(0xBDFE5D4F), _f32(0x3E11E9BF)), x, _f32(0xBE2AAE50))
    p3 = _fma(_fma(x, _f32(0x3E4CCEAC), _f32(0xBE7FFFFC)), x, _f32(0x3EAAAAAA))
    q = _fma(_fma(p1, x3, p2), x3, p3)
    r = _fma(q, x3, e * _f32(0xB95E8083))
    res = ((x - z * 0.5) + r) + e * _f32(0x3F318000)  # both products exact
    # special values: log(0) = -inf, log(inf) = inf, log(t < 0 or NaN) = NaN
    res = torch.where(t == 0, float("-inf"), res)
    res = torch.where(t == float("inf"), float("inf"), res)
    return torch.where((t < 0) | torch.isnan(t), float("nan"), res)


def _log1p_small(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p(y) for ``|y| < sqrt(2) - 1``:
    ``y - y^2/2 + y^3 * R(y)``, R a ratio of two degree-6 polynomials
    (Horner, fused)."""
    p = torch.ones_like(y)
    for c in (0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A, 0x42707982):
        p = _fma(p, y, _f32(c))
    q = torch.full_like(y, _f32(0x383DE04B))
    for c in (0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76, 0x426473AD, 0x41A05101):
        q = _fma(q, y, _f32(c))
    y2 = y * y
    return y + _fma(y2, -0.5, (y * y2) * _div(q, p))


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv(x)`` on the CPU, operation for operation."""
    y = x * -x
    lp = torch.where(y.abs() < _f32(0x3ED413CD), _log1p_small(y), _log_big(y + 1.0))
    near = lp > -5.0  # w = -log1p(-x^2) < 5
    t = torch.where(near, -2.5 - lp, _sqrt(-lp) + -3.0)
    p = _fma(_where_f32(near, 0x32F16588, 0xB951F09B), t, _where_f32(near, 0x34B84B36, 0x38D3B56B))
    for c_near, c_far in (
        (0xB66C7357, 0x3AB0DC72), (0xB6935AC1, 0xBB70BDE7), (0x396532DB, 0x3BBC127B),
        (0xBAA45408, 0xBBF9C5D7), (0xBB88E4EF, 0x3C1AA57E), (0x3E7C8F63, 0x3F8036DB),
        (0x3FC02E2F, 0x40354F7E),
    ):
        p = _fma(t, p, _where_f32(near, c_near, c_far))
    p = torch.where(x.abs() == 1.0, float("inf"), p)
    return x * p

