"""CiM-quantized matmul / linear layer — the paper's technique as a PyTorch op.

The PyTorch counterpart of ``repro.core.cim_linear``. A matmul ``y = x @ w`` is
mapped onto bit-plane compute-in-SRAM arrays: the reduction dimension K is
split into tiles of ``rows`` (one CiM array's word lines each),
activations/weights are quantized to ``a_bits``/``w_bits``, and every tile's
product-sum is digitized before the tiles are accumulated.

Modes:

  * ``exact``      — plain matmul (no CiM).
  * ``bitplane``   — faithful per-plane simulation: every (input-plane ×
                     weight-plane × tile) product-sum is an analog MAV digitized
                     by the memory-immersed ADC (``core.adc``, SAR or
                     asymmetric SAR), then recombined with signed powers of
                     two; with a ``key``, comparator noise per global row and
                     one ladder mismatch draw per call, equal to the JAX
                     package's draws (``core.prng``). Plain PyTorch on every
                     device, as the JAX package computes it in jnp outside
                     its Pallas kernels.
  * ``fake_quant`` — integer per-tile partial sums passed through the
                     RMS-equivalent composite quantizer. On a CUDA tensor this
                     runs the hand-written fake-quant kernel
                     (``repro_torch.kernels.cim_matmul``), on a CPU tensor its
                     plain PyTorch version.

  * ``int8_dot``   — integer product-sums of 8-bit codes (s8 x s8 -> s32,
                     ``torch._int_mm`` on every device, as the JAX package
                     takes a plain ``dot_general`` outside any Pallas kernel),
                     the activation scaled per tensor and the weight per
                     output column.

``ste=True`` wraps the quantized output in a straight-through estimator
(``detach``) so the op is trainable (QAT): the forward value is the CiM
product, the gradient that of the float product.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import work
from repro_torch.core import prng
from repro_torch.core import search_tree as st
from repro_torch.core.adc import ADCConfig, convert, make_reference_ladder
from repro_torch.core.cim_array import bit_planes, plane_weights
from repro_torch.core.mav_stats import analytic_code_pmf
from repro_torch.device import divisor

__all__ = [
    "CiMConfig", "CimStats", "cim_matmul", "cim_linear", "quantize_symmetric", "digitization_stats",
]


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

    def adc_config(self) -> ADCConfig:
        return ADCConfig(
            bits=self.adc_bits,
            n_ref_columns=max(32, 1 << self.adc_bits),
            comparator_sigma=self.comparator_sigma,
            ref_mismatch_sigma=self.ref_mismatch_sigma,
            mode="sar_asym" if self.search == "sar_asym" else "sar",
        )

    def search_tree(self) -> st.TreeTables:
        if self.search == "sar_asym":
            pmf = analytic_code_pmf(self.rows, self.adc_bits)
            return st.optimal_tree(pmf)
        return st.symmetric_tree(self.adc_bits)


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
    scale = torch.where(absmax > 0, absmax / divisor(qmax, absmax, absmax.dtype), torch.ones_like(absmax))
    lo = -qmax - 1 if signed else 0
    x_int = torch.clamp(torch.round(x / scale), lo, qmax)
    return x_int, scale


def _pad_k(v: torch.Tensor, rows: int, k_dim: int) -> torch.Tensor:
    """``v`` with its reduction dim (-1 for an activation (M, K), 0 for a
    weight (K, N)) zero-padded to a multiple of ``rows``."""
    pad = (-v.shape[k_dim]) % rows
    if not pad:
        return v
    return F.pad(v, (0, pad) if k_dim == -1 else (0, 0, 0, pad))


def _pad_reduction(x_int, w_int, rows):
    x_int, w_int = _pad_k(x_int, rows, -1), _pad_k(w_int, rows, 0)
    return x_int, w_int, x_int.shape[-1] // rows


def _bitplane_matmul(x_int, w_int, cfg: CiMConfig, key=None, row_offset=0, exact_comparisons: bool = False):
    """x_int (M,K) @ w_int (K,N) through per-plane CiM arrays + in-memory ADC.

    The MAV of every (plane_a, plane_w, tile) is digitized by the configured
    SAR search, reconstructed by floor (the raw code times one LSB) and
    recombined. ``row_offset`` is the global index of ``x_int``'s first row.
    With a key, ``split(key)`` gives the ladder's mismatch key (one ladder
    for the call: the reference DAC is one physical array) and the
    comparators' key, and row ``i`` draws its comparator noise from
    ``fold_in(cmp_key, row_offset + i)``: a row's draws depend only on its
    global index, as in the JAX package (all rows in one batched draw, equal
    to its ``vmap`` over rows).

    Returns (y_int float32 (M,N), CimStats). The recombined sum is exact, and
    so independent of its order, while every partial sum stays below 2^24
    granules of ``rows / 2^adc_bits``; ``comparisons`` is summed in float32 as
    the JAX package sums it (rounded above 2^24), or in int64 with
    ``exact_comparisons`` (``fabric.tiles`` runs several column tiles as
    one call where each tile's float32 total is exact).
    """
    m, _ = x_int.shape
    n = w_int.shape[1]
    r = cfg.rows
    x_int, w_int, t = _pad_reduction(x_int, w_int, r)

    xb = bit_planes(x_int, cfg.a_bits, cfg.a_signed).reshape(cfg.a_bits, m, t, r).float()
    wb = bit_planes(w_int, cfg.w_bits, cfg.w_signed).reshape(cfg.w_bits, t, r, n).float()

    # analog MAV of every (plane_a, plane_w, tile): (A, W, M, T, N) in [0,1]
    mav = torch.einsum("amtr,btrn->abmtn", xb, wb)
    del xb, wb
    mav.div_(divisor(r, mav))
    # half-LSB bias (standard comparator/DAC offset) so the discrete MAV
    # levels k/R sit mid-bin instead of exactly on code boundaries
    mav.add_(0.5 / (1 << cfg.adc_bits))

    adc_cfg = cfg.adc_config()
    if key is None:
        res = convert(mav, adc_cfg, tree=cfg.search_tree())
    else:
        mismatch_key, cmp_key = prng.split(prng.as_key(key, mav.device)).unbind(-2)
        ladder = make_reference_ladder(adc_cfg, mismatch_key, device=mav.device)
        row_ids = torch.as_tensor(row_offset, dtype=torch.int64, device=mav.device) + torch.arange(
            m, dtype=torch.int64, device=mav.device
        )
        row_keys = prng.fold_in(cmp_key, row_ids)  # (M, 2): row i of mav is axis 2
        res = convert(mav, adc_cfg, key=row_keys, tree=cfg.search_tree(), ladder=ladder, key_axis=2)
    conversions = mav.numel()
    del mav
    # floor reconstruction: digital output is the raw code scaled by one LSB,
    # zero-bias on empty tiles and exact whenever 2^adc_bits >= 2*rows
    counts = res.codes.float() / (1 << cfg.adc_bits) * adc_cfg.vdd * r
    if cfg.exact_counts:
        counts = torch.round(counts)

    wa = torch.as_tensor(plane_weights(cfg.a_bits, cfg.a_signed), dtype=torch.float32, device=counts.device)
    ww = torch.as_tensor(plane_weights(cfg.w_bits, cfg.w_signed), dtype=torch.float32, device=counts.device)
    y_int = torch.tensordot(torch.outer(wa, ww), counts.sum(dim=3), dims=([0, 1], [0, 1]))
    stats = CimStats(
        conversions=torch.tensor(conversions, dtype=torch.int32, device=counts.device),
        comparisons=(res.comparisons.to(torch.int64).sum() if exact_comparisons
                     else res.comparisons.float().sum()).to(torch.int32),
    )
    return y_int, stats


def _fq_operand(v_int: torch.Tensor, cfg: CiMConfig, k_dim: int) -> torch.Tensor:
    """An integer-valued operand as the fake-quant product takes it: its
    reduction dim ``k_dim`` (-1 for x, 0 for w) padded to whole tiles, and
    int8 on CUDA, where the kernel takes int8 operands, so both widths must
    be at most 8 bits."""
    v_int = _pad_k(v_int, cfg.rows, k_dim)
    if v_int.is_cuda:
        if cfg.a_bits > 8 or cfg.w_bits > 8:
            raise ValueError(
                f"the CUDA fake-quant kernel takes int8 operands; "
                f"a_bits={cfg.a_bits}, w_bits={cfg.w_bits} exceed 8"
            )
        v_int = v_int.to(torch.int8)
    return v_int


def _fq_product(x_c: torch.Tensor, w_c: torch.Tensor, cfg: CiMConfig):
    """The fake-quant product of operands from :func:`_fq_operand`:
    ``(y_int float32 (M, N), step)``."""
    from repro_torch.kernels.cim_matmul import cim_matmul_fq
    from repro_torch.kernels.ref import fake_quant_step

    step = fake_quant_step(cfg.rows, cfg.adc_bits, cfg.a_bits, cfg.w_bits, cfg.a_signed, cfg.w_signed)
    return cim_matmul_fq(x_c, w_c, rows=cfg.rows, step=step), step


def _fake_quant_matmul(x_int, w_int, cfg: CiMConfig):
    """Integer per-tile partial sums + RMS-equivalent composite quantizer.

    Each plane-pair's count is independently quantized with step R/2^B; the
    equivalent single quantizer on the composite tile partial sum uses the
    RMS combination of the plane recombination weights. On CUDA the operands
    go to the kernel as int8, so both widths must be at most 8 bits.
    Returns ``(y_int float32 (M, N), step)``.
    """
    return _fq_product(_fq_operand(x_int, cfg, -1), _fq_operand(w_int, cfg, 0), cfg)


INT_MM_ROWS = 32  # the CUDA int8 product runs on a multiple of 32 rows


def _int8_rows(m: int) -> int:
    """Rows the CUDA int8 product runs on: ``m`` rounded up to a multiple of
    32 (torch's ``_int_mm`` takes M > 16, and on an H100 cuBLASLt rejected
    M 17 and M 40 at K = N = 64 while M 32 and 256 ran)."""
    return -(-m // INT_MM_ROWS) * INT_MM_ROWS


def _int8_work(x_int, w_int):
    """The card's int8 product for ``roofline.op_stats``, on every device:
    ``_int_mm`` over :func:`_int8_rows` rows (int8 in, int32 out), and where
    M is padded, the pad's copy (M rows read, the padded rows written)."""
    (m, k), n = x_int.shape, w_int.shape[1]
    rows = _int8_rows(m)
    pad = m * k + rows * k if rows != m else 0
    return 2.0 * rows * k * n, 2.0 * rows * k * n, rows * k + k * n + 4 * rows * n + pad


@work.kernel("int8_mm", _int8_work)
def _int8_product(x_int: torch.Tensor, w_int: torch.Tensor) -> torch.Tensor:
    """x_int (M, K) @ w_int (K, N) of int8 codes, summed exactly in int32
    (K·127² < 2^31 for every K up to 133,000). On CUDA, cuBLAS takes K and N
    multiples of 8: M is padded with zero rows (:func:`_int8_rows`), which
    leave the other rows' sums as they are; a K or N it cannot take raises
    (the product never goes through floats). An op counter sees the card's
    padded work on every device (:func:`_int8_work`)."""
    m, k = x_int.shape
    n = w_int.shape[1]
    if not x_int.is_cuda:
        return torch._int_mm(x_int, w_int)
    if k % 8 or n % 8:
        raise ValueError(f"int8_dot on CUDA takes K and N multiples of 8; got K={k}, N={n}")
    rows = _int8_rows(m)
    if rows != m:
        x_int = F.pad(x_int, (0, 0, 0, rows - m))
    return torch._int_mm(x_int, w_int)[:m]


def _int8_dot(x: torch.Tensor, w: torch.Tensor, cfg: CiMConfig) -> torch.Tensor:
    """The ``int8_dot`` mode, computed as the JAX package computes it: the
    quantized product ``y_i32 · sx · sw`` in float32, the STE's
    ``y_lin + (y_q - y_lin)`` in ``y_lin``'s type, cast to ``x``'s type."""
    batch_shape = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1])
    x_int, sx = quantize_symmetric(xm, 8, True)
    w_int, sw = quantize_symmetric(w, 8, True, per_axis=-1)
    y_i32 = _int8_product(x_int.to(torch.int8), w_int.to(torch.int8))
    y = y_i32.float() * sx * sw
    if cfg.ste:
        dt = torch.promote_types(x.dtype, w.dtype)
        y_lin = xm.to(dt) @ w.to(dt)
        y = y_lin + (y.to(y_lin.dtype) - y_lin).detach()
    return y.reshape(*batch_shape, w.shape[1]).to(x.dtype)


def cim_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg: CiMConfig,
    key=None,
    return_stats: bool = False,
):
    """``y = x @ w`` through the CiM pipeline.

    ``x``: (..., K); ``w``: (K, N). Leading dims of x are flattened. ``key``
    (a ``core.prng`` key) draws the bit-plane ADC's noise; ``fake_quant``
    and ``exact`` ignore it, as in the JAX package.
    """
    stats = None
    if cfg.mode == "exact":
        y = x @ w
    elif cfg.mode == "int8_dot":
        y = _int8_dot(x, w, cfg)
    elif cfg.mode == "bitplane":
        batch_shape = x.shape[:-1]
        xm = x.reshape(-1, x.shape[-1])
        x_int, sx = quantize_symmetric(xm, cfg.a_bits, cfg.a_signed)
        w_int, sw = quantize_symmetric(w, cfg.w_bits, cfg.w_signed, per_axis=-1)
        y_int, stats = _bitplane_matmul(x_int, w_int, cfg, key)
        y = y_int * sx * sw  # sw broadcasts (1, N)
        if cfg.ste:
            y = _ste(y, xm, w)
        y = y.reshape(*batch_shape, w.shape[1])
    else:
        from repro_torch.kernels.ops import cim_matmul_op

        # under the STE the kernel's output is a constant of autograd, so its
        # operands need no graph
        xq, wq = (x.detach(), w.detach()) if cfg.ste else (x, w)
        y = cim_matmul_op(
            xq, wq, rows=cfg.rows, adc_bits=cfg.adc_bits, mode="fake_quant",
            a_bits=cfg.a_bits, w_bits=cfg.w_bits,
            a_signed=cfg.a_signed, w_signed=cfg.w_signed,
        )
        if cfg.ste:
            y = _ste(y, x, w)
    if return_stats:
        if stats is None:
            z = torch.zeros((), dtype=torch.int32, device=y.device)
            stats = CimStats(z, z)
        return y, stats
    return y


def _ste(y_q: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: the forward value of ``y_q``, the gradient
    of ``x @ w``. As in the JAX package, the product is taken in the type
    that ``x`` and ``w`` promote to (bf16 activations against float32
    weights: float32) and the value is ``y_lin + (y_q - y_lin)``, which
    rounds as JAX's does."""
    dt = torch.promote_types(x.dtype, w.dtype)
    y_lin = x.to(dt) @ w.to(dt)
    return y_lin + (y_q - y_lin).detach()


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


def digitization_stats(cfg: CiMConfig, m: int, k: int, n: int) -> dict:
    """Analytic per-matmul digitization cost (conversions, expected
    comparisons) for the configured search under the Binomial MAV model."""
    t = -(-k // cfg.rows)
    conversions = cfg.a_bits * cfg.w_bits * m * t * n
    pmf = analytic_code_pmf(cfg.rows, cfg.adc_bits)
    tree = cfg.search_tree()
    e_cmp = tree.expected_depth(pmf)
    return {
        "conversions": conversions,
        "expected_comparisons_per_conversion": e_cmp,
        "total_comparisons": conversions * e_cmp,
    }
