"""Numerically execute a mapped placement — batched, tile by tile.

The PyTorch counterpart of ``repro.fabric.execute``. The mapped path is
*bit-for-bit* the unmapped op: quantization scales are computed once at the
fabric level (per-tensor activations, per-column weights — exactly
``core.cim_linear.cim_matmul``'s front-end), then every output-column tile of
``fabric.cols`` columns runs through the same per-plane machinery:

  * ``bitplane``   — ``core.cim_linear``'s faithful per-plane path per tile
                     (``fabric.tiles.column_tile_matmul``), plain PyTorch as in
                     the JAX package, noiseless or with per-tile and per-row
                     noise keys;
  * ``fake_quant`` — ``kernels.ops.cim_matmul_op`` per tile: on a CUDA tensor
                     the hand-written CiM fake-quant kernel (K1), one launch
                     per tile, as the JAX package calls its Pallas kernel per
                     tile; on a CPU tensor the kernel's plain version.

K-tiling at ``rows`` boundaries happens *inside* the per-tile op and lands on
the same reduction slices the placement assigns to individual arrays.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.cim_linear import CimStats, CiMConfig, quantize_symmetric
from repro_torch.fabric.mapper import LayerPlacement, map_matmul
from repro_torch.fabric.tiles import analytic_cim_stats, column_tile_matmul
from repro_torch.fabric.topology import FabricConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["execute_matmul", "execute_linear"]


def execute_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    fabric: FabricConfig,
    cim: CiMConfig,
    placement: Optional[LayerPlacement] = None,
    key=None,
    return_stats: bool = False,
    use_kernel: bool = True,
):
    """``y = x @ w`` executed tile-wise over the mapped fabric placement.

    ``x``: (..., K); ``w``: (K, N), on one device. Equals
    ``cim_matmul(x, w, cim)`` bit for bit in both ``bitplane`` and
    ``fake_quant`` modes (noiseless ADC); with a ``key`` (a ``core.prng``
    key) the bit-plane tiles draw the JAX package's noise.

    ``return_stats=True`` is meaningful in both modes: ``bitplane`` counts
    the conversions/comparisons actually performed; ``fake_quant`` counts
    them analytically (``fabric.tiles.analytic_cim_stats``: a count past
    int32 raises ``OverflowError`` as in the JAX package, whose kernel path
    counts on every call and so raises without stats too; the port counts
    only when asked). ``use_kernel=False`` runs ``fake_quant`` through
    ``column_tile_matmul`` in one full-width call instead of one kernel call
    per tile.

    Example::

        >>> from repro_torch.core import prng
        >>> from repro_torch.core.cim_linear import CiMConfig
        >>> fb = FabricConfig(mode="hybrid", n_arrays=12)
        >>> cim = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=False)
        >>> x = prng.normal(prng.PRNGKey(0), (2, 40))
        >>> w = prng.normal(prng.PRNGKey(1), (40, 70))
        >>> tuple(execute_matmul(x, w, fb, cim).shape)
        (2, 70)
    """
    if cim.mode not in ("bitplane", "fake_quant"):
        raise ValueError(f"fabric execution needs bitplane|fake_quant, got {cim.mode!r}")
    batch_shape = x.shape[:-1]
    k = x.shape[-1]
    n = w.shape[1]
    xm = x.reshape(-1, k)
    if placement is None:
        placement = map_matmul("matmul", xm.shape[0], k, n, fabric, cim=cim)
    if (placement.k, placement.n) != (k, n):
        raise ValueError(f"placement is for K={placement.k},N={placement.n}; got K={k},N={n}")

    # observability: host-side analytic accounting only (placement counts are
    # Python ints), so metrics cannot perturb the computation
    if obs_metrics.active():
        obs_metrics.inc("fabric_matmuls_total", help="Mapped matmuls executed.")
        obs_metrics.inc(
            "fabric_conversions_total",
            cim.a_bits * cim.w_bits * xm.shape[0] * placement.k_tiles * n,
            help="Analytic ADC conversions per executed matmul "
            "(planes x rows x k-tiles x columns).",
        )
    with obs_trace.span(
        "fabric.execute.matmul",
        layer=placement.name, m=xm.shape[0], k=k, n=n, mode=cim.mode,
    ):
        cols = fabric.cols
        if cim.mode == "fake_quant" and use_kernel:
            from repro_torch.kernels.ops import cim_matmul_op

            # the op re-derives the same per-tensor / per-column scales from
            # the float operands and applies them itself
            parts = [
                cim_matmul_op(
                    xm, w[:, nt * cols:min((nt + 1) * cols, n)],
                    rows=cim.rows, adc_bits=cim.adc_bits, mode="fake_quant",
                    a_bits=cim.a_bits, w_bits=cim.w_bits,
                    a_signed=cim.a_signed, w_signed=cim.w_signed,
                )
                for nt in range(placement.n_tiles)
            ]
            y_q = torch.cat(parts, dim=1)
            # the kernel performs the same tiles x plane-pairs x columns of
            # conversions as the faithful path: count them analytically, when
            # asked (the JAX package counts on every call, and so raises its
            # int32 OverflowError at full-width shapes even without stats)
            stats = None
            if return_stats:
                stats = analytic_cim_stats(cim, xm.shape[0], placement.k_tiles, n, device=y_q.device)
        else:
            # fabric-level quantization: identical to the unmapped op's front-end
            x_int, sx = quantize_symmetric(xm, cim.a_bits, cim.a_signed)
            w_int, sw = quantize_symmetric(w, cim.w_bits, cim.w_signed, per_axis=-1)
            y_int, stats = column_tile_matmul(x_int, w_int, cim, cols, key=key)
            y_q = y_int * sx * sw

        if cim.ste:
            y_lin = xm @ w
            y_q = y_lin + (y_q - y_lin).detach()

    y = y_q.reshape(*batch_shape, n)
    if return_stats:
        return y, CimStats(stats.conversions, stats.comparisons)
    return y


def execute_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    fabric: Optional[FabricConfig] = None,
    cim: Optional[CiMConfig] = None,
    placement: Optional[LayerPlacement] = None,
    key=None,
):
    """Mapped counterpart of ``core.cim_linear.cim_linear``.

    Example::

        >>> from repro_torch.core import prng
        >>> x = prng.normal(prng.PRNGKey(0), (4, 48))
        >>> w = prng.normal(prng.PRNGKey(1), (48, 40))
        >>> tuple(execute_linear(x, w, bias=torch.zeros(40)).shape)
        (4, 40)
    """
    if fabric is None:
        fabric = FabricConfig()
    if cim is None:
        cim = CiMConfig(mode="bitplane", adc_bits=fabric.adc_bits, rows=fabric.rows, ste=False)
    y = execute_matmul(x, w, fabric, cim, placement=placement, key=key)
    if bias is not None:
        y = y + bias
    return y
