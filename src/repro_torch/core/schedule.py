"""Collaborative digitization schedules among CiM arrays (paper Figs. 2, 3, 5c).

The paper's arrays alternate between *compute* (analog MAV) and *digitize*
(reference generation for a neighbor) roles. This module builds cycle-accurate
schedules for the three networking configurations and derives system-level
throughput/utilization — the quantities behind the paper's claim that the
halved per-array throughput is recovered by packing more arrays in the saved
ADC area.

Configurations:
  * ``pair_sar``    — arrays (A, B): A computes while B digitizes A's previous
                      MAV; roles swap each conversion (Fig. 2).
  * ``flash``       — 1-to-k coupling: k arrays generate 2^f − 1 references in
                      parallel; one comparison cycle per conversion (Fig. 1 right).
  * ``hybrid``      — Fig. 3/5c: CiM arrays take turns using the shared Flash
                      bank for their MSBs, then pair off for SAR on the rest.
"""

from __future__ import annotations

import dataclasses
from typing import List

__all__ = ["Slot", "ScheduleResult", "pair_sar_schedule", "hybrid_schedule", "throughput_summary"]


@dataclasses.dataclass(frozen=True)
class Slot:
    cycle: int
    array: str
    role: str  # compute | ref_gen | flash_ref | compare | idle


@dataclasses.dataclass
class ScheduleResult:
    slots: List[Slot]
    n_cycles: int
    n_conversions: int
    n_arrays: int

    @property
    def conversions_per_cycle_per_array(self) -> float:
        return self.n_conversions / (self.n_cycles * self.n_arrays)

    def utilization(self, role: str = "compute") -> float:
        busy = sum(1 for s in self.slots if s.role == role)
        return busy / (self.n_cycles * self.n_arrays)


def pair_sar_schedule(bits: int = 5, n_conversions: int = 4) -> ScheduleResult:
    """Two arrays alternating compute/digitize (Fig. 2a). One conversion =
    1 compute cycle + ``bits`` reference/compare cycles on the partner."""
    slots: List[Slot] = []
    cycle = 0
    for conv in range(n_conversions):
        computer, digitizer = ("A", "B") if conv % 2 == 0 else ("B", "A")
        slots.append(Slot(cycle, computer, "compute"))
        slots.append(Slot(cycle, digitizer, "idle"))
        cycle += 1
        for _ in range(bits):
            slots.append(Slot(cycle, digitizer, "ref_gen"))
            # the computing array holds V_MAV; comparator fires this cycle
            slots.append(Slot(cycle, computer, "hold"))
            cycle += 1
    return ScheduleResult(slots, cycle, n_conversions, 2)


def hybrid_schedule(
    bits: int = 5, flash_bits: int = 2, n_cim_arrays: int = 3
) -> ScheduleResult:
    """Fig. 3: ``n_cim_arrays`` compute arrays sequentially use a shared bank
    of 2^flash_bits − 1 reference arrays for their MSBs, then each pairs with
    the nearest reference array for SAR on the remaining bits (in parallel
    across arrays once freed)."""
    n_ref = (1 << flash_bits) - 1
    names_cim = [f"C{i}" for i in range(n_cim_arrays)]
    names_ref = [f"R{i}" for i in range(n_ref)]
    slots: List[Slot] = []
    cycle = 0
    # compute phase: all CiM arrays evaluate their MAV simultaneously
    for nm in names_cim:
        slots.append(Slot(cycle, nm, "compute"))
    for nm in names_ref:
        slots.append(Slot(cycle, nm, "flash_ref"))  # references precharge
    cycle += 1
    # flash phase: one comparison cycle per CiM array against the shared bank
    for i, nm in enumerate(names_cim):
        slots.append(Slot(cycle + i, nm, "compare"))
        for r in names_ref:
            slots.append(Slot(cycle + i, r, "flash_ref"))
    # SAR tails run in parallel, staggered by their flash slot
    sar_cycles = bits - flash_bits
    end = cycle
    for i, nm in enumerate(names_cim):
        start = cycle + i + 1
        ref = names_ref[i % n_ref]
        for c in range(sar_cycles):
            slots.append(Slot(start + c, nm, "hold"))
            slots.append(Slot(start + c, ref, "ref_gen"))
        end = max(end, start + sar_cycles)
    return ScheduleResult(slots, end, n_cim_arrays, n_cim_arrays + n_ref)


def throughput_summary(bits: int = 5, flash_bits: int = 2) -> dict:
    """System-level throughput comparison used in DESIGN/EXPERIMENTS.

    ``area_budget_ratio``: with a dedicated SAR ADC per array costing ~25x the
    in-memory digitizer (Table I), the ADC area of one conventional array
    funds ~the digitizer area of 25 collaborative arrays; even at half duty
    cycle the collaborative scheme nets >10x conversions per unit area.
    """
    pair = pair_sar_schedule(bits=bits, n_conversions=8)
    hyb = hybrid_schedule(bits=bits, flash_bits=flash_bits, n_cim_arrays=3)
    area_ratio = 5235.20 / 207.8
    return {
        "pair_sar_conv_per_cycle_per_array": pair.conversions_per_cycle_per_array,
        "hybrid_conv_per_cycle_per_array": hyb.conversions_per_cycle_per_array,
        "dedicated_adc_area_ratio": area_ratio,
        "conversions_per_area_gain": area_ratio
        * pair.conversions_per_cycle_per_array
        / (1.0 / (1 + bits)),
    }
