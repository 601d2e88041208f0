"""MAV (multiply-average) statistics of bit-plane CiM arrays (paper Fig. 4a).

Under single-ended 8T processing, a column discharges only when stored bit AND
input bit are both '1'. With i.i.d. Bernoulli(p_w) weight bits and
Bernoulli(p_x) input bits, the number of discharging rows is
Binomial(R, p_w * p_x) and MAV = count / R — strongly skewed toward 0
(p = 0.25 for uniform bits). ReLU sparsity and weight regularization skew it
further. These distributions seed the asymmetric search tree.

Pure numpy: a copy of ``repro.core.mav_stats`` (the port imports nothing of
``repro``).
"""

from __future__ import annotations

import numpy as np
from repro_torch.core.scipy_free_stats import binom_pmf

__all__ = [
    "binom_pmf",
    "analytic_mav_pmf",
    "code_pmf_from_mav",
    "analytic_code_pmf",
    "empirical_code_pmf",
    "entropy_bits",
]


def analytic_mav_pmf(rows: int, p_discharge: float = 0.25) -> np.ndarray:
    """PMF over MAV levels k/rows, k = 0..rows (Binomial model)."""
    return binom_pmf(rows, p_discharge)


def code_pmf_from_mav(mav_pmf: np.ndarray, rows: int, bits: int) -> np.ndarray:
    """Push the MAV level distribution through the ideal B-bit quantizer."""
    n = 1 << bits
    pmf = np.zeros(n)
    for k, p in enumerate(mav_pmf):
        v = k / rows
        code = min(int(np.floor(v * n)), n - 1)
        pmf[code] += p
    return pmf


def analytic_code_pmf(rows: int = 16, bits: int = 5, p_discharge: float = 0.25):
    return code_pmf_from_mav(analytic_mav_pmf(rows, p_discharge), rows, bits)


def empirical_code_pmf(samples: np.ndarray, bits: int, vdd: float = 1.0):
    """Code histogram from observed MAV voltage samples (calibration path)."""
    n = 1 << bits
    codes = np.clip(np.floor(np.asarray(samples) / vdd * n), 0, n - 1).astype(int)
    pmf = np.bincount(codes, minlength=n).astype(np.float64)
    s = pmf.sum()
    return pmf / s if s > 0 else np.full(n, 1.0 / n)


def entropy_bits(pmf: np.ndarray) -> float:
    p = np.asarray(pmf, dtype=np.float64)
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())
