"""The shared per-(column-tile, K-shard) inner loop of every fabric executor.

The PyTorch counterpart of ``repro.fabric.tiles``. ``fabric.execute`` runs
one chip's quantized ``(M, K) @ (K, N)`` block through
:func:`column_tile_matmul`: walk the output-column tiles, run each through
``core.cim_linear``'s per-plane machinery with a per-tile ``fold_in(key, nt)``
noise key, and accumulate conversion/comparison stats. The sharded
executor (``fabric.shard``, one call per chip block), the fused chain
program (``fabric.program``, one call per chip and layer) and the fused
graph (``fabric.graph``, one call per chip and matmul node) share this one
definition, as in the JAX package.

Stats are meaningful in BOTH fidelity modes: ``bitplane`` counts the actual
ADC conversions / comparator firings performed by ``_bitplane_matmul``;
``fake_quant`` counts them analytically via :func:`analytic_cim_stats` — the
same ``planes x M x k-tiles x N`` formula as ``LayerPlacement.conversions``
and ``core.cim_linear.digitization_stats``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.cim_linear import CimStats, CiMConfig, _bitplane_matmul, _fake_quant_matmul
from repro_torch.core.mav_stats import analytic_code_pmf

__all__ = ["column_tile_matmul", "analytic_cim_stats"]

_INT32 = (-(1 << 31), (1 << 31) - 1)
#: MAV elements one grouped noiseless bit-plane call may hold (128 MB of float32)
GROUP_ELEMENTS = 1 << 25


def _int32(value: int, device=None) -> torch.Tensor:
    """A 0-d int32 tensor, raising ``OverflowError`` outside int32 as
    ``jnp.asarray(value, jnp.int32)`` does (never widened quietly)."""
    if not _INT32[0] <= value <= _INT32[1]:
        raise OverflowError(f"Python integer {value} out of bounds for int32")
    return torch.tensor(value, dtype=torch.int32, device=device)


def analytic_cim_stats(cim: CiMConfig, m: int, k_tiles: int, n: int, device=None) -> CimStats:
    """Analytic digitization stats for one executed ``(m, k_tiles*rows, n)``
    block, as int32 tensors on ``device``: every (input-plane x weight-plane)
    pair of every (row, k-tile, output-column) triple is one conversion;
    expected comparator firings follow the configured search tree under the
    Binomial MAV model — exactly ``digitization_stats``'s accounting. A count
    beyond int32 raises ``OverflowError``, as in the JAX package.

    Example::

        >>> from repro_torch.core.cim_linear import CiMConfig
        >>> cim = CiMConfig(mode="fake_quant", a_bits=4, w_bits=4, adc_bits=5, rows=16)
        >>> st = analytic_cim_stats(cim, m=2, k_tiles=3, n=8)
        >>> int(st.conversions), int(st.comparisons) > 0
        (768, True)
    """
    conversions = cim.a_bits * cim.w_bits * m * k_tiles * n
    e_cmp = cim.search_tree().expected_depth(analytic_code_pmf(cim.rows, cim.adc_bits))
    return CimStats(
        conversions=_int32(conversions, device),
        comparisons=_int32(round(conversions * float(e_cmp)), device),
    )


def column_tile_matmul(
    x_int: torch.Tensor,
    w_int: torch.Tensor,
    cim: CiMConfig,
    cols: int,
    key=None,
    row_offset=0,
    count: bool = True,
) -> Tuple[torch.Tensor, Optional[CimStats]]:
    """Execute one chip's quantized block tile-by-tile over its output columns.

    ``x_int``: (M, K) integer-valued activations; ``w_int``: (K, N)
    integer-valued weights. Output-column tile ``nt`` covers columns
    ``[nt*cols, (nt+1)*cols)`` and draws its ADC noise from
    ``fold_in(key, nt)`` then per-row ``fold_in(·, row_offset + i)`` inside
    ``_bitplane_matmul``, as in the JAX package. ``row_offset`` is the global
    index of ``x_int``'s first row.

    Without a key (no noise is drawn) a column's codes do not depend on the
    others, so neighbouring tiles run as one ``_bitplane_matmul`` call of up
    to :data:`GROUP_ELEMENTS` MAV elements, wherever every tile's comparison
    total stays exact in float32 (below 2^24 even at one comparison per
    code level); the call sums its comparisons exactly, so outputs and
    stats equal the tile-by-tile walk. The JAX package walks tile by tile.

    Returns the UNSCALED integer-valued result ``(M, N)`` float32 plus
    :class:`CimStats` (actual counts in ``bitplane`` mode, analytic in
    ``fake_quant``, where one full-width call equals the per-tile walk).
    ``count=False`` skips the analytic ``fake_quant`` count and returns
    ``None`` for it: a count past int32 raises (:func:`analytic_cim_stats`),
    so the executors count only when asked. The JAX package counts on every
    call.

    Example::

        >>> from repro_torch.core import prng
        >>> from repro_torch.core.cim_linear import CiMConfig, quantize_symmetric
        >>> cim = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=False)
        >>> x_int, _ = quantize_symmetric(prng.normal(prng.PRNGKey(0), (2, 32)), 4, True)
        >>> w_int, _ = quantize_symmetric(prng.normal(prng.PRNGKey(1), (32, 48)), 4, True, per_axis=-1)
        >>> y, st = column_tile_matmul(x_int, w_int, cim, cols=32)
        >>> tuple(y.shape), int(st.conversions)
        ((2, 48), 3072)
    """
    n = w_int.shape[1]
    if cim.mode != "bitplane":
        y, _ = _fake_quant_matmul(x_int, w_int, cim)
        if not count:
            return y, None
        k_tiles = math.ceil(x_int.shape[1] / cim.rows)
        return y, analytic_cim_stats(cim, x_int.shape[0], k_tiles, n, device=y.device)
    group, exact = 1, False
    if key is not None:
        key = prng.as_key(key, x_int.device)
    else:
        per_tile = cim.a_bits * cim.w_bits * x_int.shape[0] * math.ceil(x_int.shape[1] / cim.rows) * cols
        if per_tile << cim.adc_bits < 1 << 24:
            group, exact = max(1, GROUP_ELEMENTS // max(per_tile, 1)), True
    parts = []
    conversions = torch.zeros((), dtype=torch.int32, device=x_int.device)
    comparisons = torch.zeros((), dtype=torch.int32, device=x_int.device)
    for nt in range(0, math.ceil(n / cols), group):
        n0, n1 = nt * cols, min((nt + group) * cols, n)
        tkey = prng.fold_in(key, nt) if key is not None else None
        y_t, st = _bitplane_matmul(x_int, w_int[:, n0:n1], cim, tkey, row_offset, exact_comparisons=exact)
        conversions = conversions + st.conversions
        comparisons = comparisons + st.comparisons
        parts.append(y_t)
    y = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return y, CimStats(conversions, comparisons)
