"""Frequency / supply-voltage scaling models (paper Fig. 7c,d).

The paper sweeps clock frequency and VDD on the 65 nm chip and reports MNIST
accuracy and power. We model the two dominant mechanisms:

  * **Frequency** — at short clock periods the comparator/DAC settling becomes
    incomplete; the residual settling error acts like extra input-referred
    noise growing as ``exp(-T_clk / tau)``.
  * **Voltage** — comparator input-referred noise is roughly constant in
    absolute volts, so the *relative* noise (vs the full-scale VDD) grows as
    VDD drops; conversion energy scales as C·V².

Constants are calibrated so that the chip's reported operating point
(10 MHz, 1.0 V, 74.23 pJ / 5-bit conversion) is reproduced and accuracy
degrades in the >40 MHz / <0.8 V regime, matching the paper's trend.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["AnalogEnv", "effective_sigma", "conversion_energy_pj", "power_uw"]

# Calibration anchors (65 nm test chip, Table I / Fig. 7)
_NOMINAL_VDD = 1.0  # V
_NOMINAL_FREQ = 10e6  # Hz
_BASE_SIGMA = 2e-3  # V rms comparator noise at nominal point
_SETTLE_TAU = 2.2e-9  # s — settling time constant of DAC+comparator
_SETTLE_T0 = 8.0e-9  # s — fixed non-settling overhead per cycle
_E_CYCLE_PJ = 74.23 / 5.0  # pJ per comparison cycle at nominal (Table I)


@dataclasses.dataclass(frozen=True)
class AnalogEnv:
    """Operating point of the analog periphery."""

    freq_hz: float = _NOMINAL_FREQ
    vdd: float = _NOMINAL_VDD


def effective_sigma(env: AnalogEnv) -> float:
    """Input-referred comparator noise [V rms] at the operating point."""
    # Voltage: absolute noise mildly increases as VDD drops (gm degradation).
    v_term = _BASE_SIGMA * (_NOMINAL_VDD / env.vdd) ** 1.5
    # Frequency: incomplete settling leaves a deterministic-ish residue that we
    # treat as noise; full-scale referred.
    t_clk = 1.0 / env.freq_hz
    settle = np.exp(-max(t_clk - _SETTLE_T0, 0.0) / _SETTLE_TAU)
    f_term = env.vdd * 0.5 * settle
    return float(np.sqrt(v_term**2 + f_term**2))


def conversion_energy_pj(env: AnalogEnv, comparisons: float) -> float:
    """Energy of one conversion [pJ]: cycles × CV² -scaled cycle energy."""
    return float(comparisons * _E_CYCLE_PJ * (env.vdd / _NOMINAL_VDD) ** 2)


def power_uw(env: AnalogEnv, comparisons_per_conversion: float) -> float:
    """ADC power [µW] at full conversion rate (one conversion per
    ``comparisons`` cycles)."""
    conv_rate = env.freq_hz / max(comparisons_per_conversion, 1e-9)
    e_pj = conversion_energy_pj(env, comparisons_per_conversion)
    return float(e_pj * 1e-12 * conv_rate * 1e6)
