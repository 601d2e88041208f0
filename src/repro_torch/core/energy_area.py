"""Analytic area / energy / latency models (paper Table I, Fig. 7a,b).

Anchored to the paper's measured numbers and the reference ADC survey [19]:

  ===============  ======  ===========  ========
  Architecture      Tech    Area (µm²)   Energy (pJ), 5-bit @ 10 MHz
  ===============  ======  ===========  ========
  SAR   [19]        40 nm   5235.20      105
  Flash [19]        40 nm   10703.36     952
  In-memory (ours)  65 nm   207.8        74.23
  ===============  ======  ===========  ========

Scaling rules used for the design-space curves (standard first-order models):
  * SAR:   area ~ binary-weighted cap DAC (∝ 2^B) + B·logic; latency B cycles;
           energy ~ DAC switching (∝ 2^B·V²) + B comparator firings.
  * Flash: area/energy ∝ (2^B − 1) comparators + ladder; latency 1 cycle.
  * In-memory: the DAC *is* the neighbor array's parasitic bit lines → area is
           one comparator + precharge/transmission gates, nearly flat in B;
           latency B cycles (SAR), 1 (flash coupling), 1 + (B−f) (hybrid), or
           the expected asymmetric-search depth.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import search_tree as st
from repro_torch.core.mav_stats import analytic_code_pmf

__all__ = [
    "ADC_STYLES",
    "area_um2",
    "energy_pj",
    "latency_cycles",
    "table1",
    "design_space",
]

_ANCHOR_BITS = 5

# Measured anchors at 5 bits.
_AREA_ANCHOR = {"sar": 5235.20, "flash": 10703.36, "in_memory": 207.8}
_ENERGY_ANCHOR = {"sar": 105.0, "flash": 952.0, "in_memory": 74.23}
_TECH = {"sar": "40nm", "flash": "40nm", "in_memory": "65nm"}

ADC_STYLES = (
    "sar",
    "flash",
    "in_memory",
    "in_memory_hybrid",
    "in_memory_asym",
    "in_memory_flash",
)


def _style_base(style: str) -> str:
    return "in_memory" if style.startswith("in_memory") else style


def area_um2(style: str, bits: int = 5) -> float:
    """ADC area vs precision, anchored at the 5-bit measured points."""
    base = _style_base(style)
    a5 = _AREA_ANCHOR[base]
    if base == "sar":
        # cap-DAC (2^B unit caps) dominates; ~15% fixed comparator+logic
        dac5, fixed = 0.85 * a5, 0.15 * a5
        return fixed * (bits / _ANCHOR_BITS) + dac5 * (2.0**bits / 2.0**_ANCHOR_BITS)
    if base == "flash":
        # 2^B − 1 comparators + encoder
        return a5 * (2.0**bits - 1.0) / (2.0**_ANCHOR_BITS - 1.0)
    # in-memory: comparator + precharge array control; control grows ~linearly
    fixed, per_bit = 0.80 * a5, 0.04 * a5
    return fixed + per_bit * bits


def latency_cycles(
    style: str,
    bits: int = 5,
    flash_bits: int = 2,
    pmf: Optional[np.ndarray] = None,
    rows: int = 16,
) -> float:
    """Conversion latency in comparison cycles (paper Fig. 7b)."""
    if style == "flash":
        return 1.0
    if style == "sar":
        return float(bits)
    if style == "in_memory":
        return float(bits)  # SAR-mode memory-immersed
    if style == "in_memory_flash":
        return 1.0  # one-to-many coupling: all references in parallel
    if style == "in_memory_hybrid":
        return 1.0 + (bits - flash_bits)
    if style == "in_memory_asym":
        if pmf is None:
            pmf = analytic_code_pmf(rows, bits)
        return st.optimal_tree(pmf).expected_depth(pmf)
    raise ValueError(style)


def energy_pj(
    style: str,
    bits: int = 5,
    freq_hz: float = 10e6,
    vdd: float = 1.0,
    flash_bits: int = 2,
    pmf: Optional[np.ndarray] = None,
    rows: int = 16,
    flash_share: int = 3,
) -> float:
    """Energy per conversion [pJ], anchored at the measured 5-bit points.

    ``flash_share``: in hybrid mode the Flash-phase references are generated
    once and shared among this many CiM arrays (paper §II-B), amortizing the
    reference-generation energy.
    """
    v2 = (vdd / 1.0) ** 2
    base = _style_base(style)
    if base == "sar":
        return _ENERGY_ANCHOR["sar"] * (bits / _ANCHOR_BITS) * v2
    if base == "flash":
        return (
            _ENERGY_ANCHOR["flash"]
            * (2.0**bits - 1.0)
            / (2.0**_ANCHOR_BITS - 1.0)
            * v2
        )
    # in-memory: per-cycle energy = comparator + neighbor-array reference
    # precharge. Anchor: 5 symmetric SAR cycles = 74.23 pJ.
    e_cycle = _ENERGY_ANCHOR["in_memory"] / _ANCHOR_BITS
    e_cmp, e_ref = 0.4 * e_cycle, 0.6 * e_cycle  # comparator / reference split
    if style == "in_memory":
        return bits * (e_cmp + e_ref) * v2
    if style == "in_memory_asym":
        cyc = latency_cycles(style, bits, pmf=pmf, rows=rows)
        return cyc * (e_cmp + e_ref) * v2
    if style == "in_memory_flash":
        # one comparison cycle; 2^B - 1 neighbor-array references precharged
        # in parallel, shared among `flash_share` compute arrays per bank
        n_ref = 2.0**bits - 1.0
        return n_ref * (e_cmp + e_ref / flash_share) * v2
    if style == "in_memory_hybrid":
        n_flash_ref = 2.0**flash_bits - 1.0
        # flash phase: n_flash_ref refs shared across `flash_share` arrays,
        # n_flash_ref comparator firings; SAR phase: (bits - flash_bits) cycles.
        e_flash = n_flash_ref * (e_ref / flash_share + e_cmp)
        e_sar = (bits - flash_bits) * (e_cmp + e_ref)
        return (e_flash + e_sar) * v2
    raise ValueError(style)


def table1() -> dict[str, dict]:
    """Reproduce paper Table I."""
    out = {}
    for style in ("sar", "flash", "in_memory"):
        out[style] = {
            "tech": _TECH[style],
            "area_um2": round(area_um2(style, 5), 2),
            "energy_pj": round(energy_pj(style, 5), 2),
        }
    return out


def design_space(bit_range=range(3, 9)) -> dict:
    """Area/latency/energy curves per style vs precision (Fig. 7a,b)."""
    out: dict = {}
    for style in ADC_STYLES:
        out[style] = {
            "bits": list(bit_range),
            "area_um2": [area_um2(style, b) for b in bit_range],
            "latency_cycles": [latency_cycles(style, b) for b in bit_range],
            "energy_pj": [energy_pj(style, b) for b in bit_range],
        }
    return out
