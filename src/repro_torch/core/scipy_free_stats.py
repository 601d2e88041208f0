"""Minimal distribution helpers without scipy (a copy of
``repro.core.scipy_free_stats``; the port imports nothing of ``repro``)."""

from __future__ import annotations

import numpy as np

__all__ = ["binom_pmf"]


def binom_pmf(n: int, p: float) -> np.ndarray:
    """Binomial(n, p) pmf over k = 0..n, computed stably in log space."""
    if not 0.0 <= p <= 1.0:
        raise ValueError("p must be in [0, 1]")
    k = np.arange(n + 1)
    if p == 0.0:
        out = np.zeros(n + 1)
        out[0] = 1.0
        return out
    if p == 1.0:
        out = np.zeros(n + 1)
        out[-1] = 1.0
        return out
    from math import lgamma

    log_comb = np.array(
        [lgamma(n + 1) - lgamma(i + 1) - lgamma(n - i + 1) for i in k]
    )
    logp = log_comb + k * np.log(p) + (n - k) * np.log1p(-p)
    pmf = np.exp(logp)
    return pmf / pmf.sum()
