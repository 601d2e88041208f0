"""Cycle-pipelined multi-conversion schedules over fabric groups.

Extends ``core.schedule`` (one-shot Figs. 2/3 timelines) to steady-state
pipelines: conversions are issued back-to-back under explicit resource
reservation — an array is either computing, holding its analog MAV for
digitization, generating references, or comparing; the hybrid/flash reference
banks are serialized shared resources (a reference array cannot hold flash
references and run a SAR ref-gen ramp in the same cycle).

Physical constraints encoded:
  * the *computing* array holds V_MAV on its sum lines until its digitization
    completes — it cannot start the next MAV (the paper's halved per-array
    throughput in pair-SAR mode);
  * a flash compare needs the entire reference bank for that cycle;
  * conventional baselines get a sample-and-hold dedicated ADC, so the array
    computes the next MAV while the ADC converts the previous one (the
    strongest-possible baseline for the iso-area comparison).

The headline check lives in :func:`iso_area_comparison`: at equal chip area
the in-memory fabric's cheap digitizers (Table I) buy enough extra arrays to
beat the conventional-ADC fabric's conversions/cycle/mm^2 (pair_sar, hybrid),
reproducing the paper's throughput-recovery claim.

The PyTorch counterpart of ``repro.fabric.pipeline`` (pure Python), with the
mesh functions: :func:`overlapped_mesh_latency` (a sharded layer list's
double-buffered link overlap) and :func:`link_validation` (the fused
program's measured collective seconds beside the modeled link time).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.core.schedule import ScheduleResult, Slot, pair_sar_schedule
from repro_torch.fabric.topology import FabricConfig

__all__ = [
    "pipelined_schedule",
    "fabric_throughput",
    "iso_area_comparison",
    "conversion_cycles",
    "overlap_rounds",
    "overlapped_mesh_latency",
    "link_validation",
]


def conversion_cycles(placement, rate_per_compute: float) -> float:
    """Cycles to drain one layer's conversions on its busiest compute array —
    the per-layer latency formula of ``fabric.report``'s rows (and of the
    JAX package's mesh overlap, one definition)."""
    return placement.conversions_per_array_max / rate_per_compute


def _pair_sar(fabric: FabricConfig, n_conversions: int) -> ScheduleResult:
    # Fig. 2's role-swap timeline admits no extra pipelining — the computing
    # array holds V_MAV throughout its digitization — so the steady state IS
    # the core one-shot schedule, back to back; delegate rather than re-model.
    return pair_sar_schedule(bits=fabric.adc_bits, n_conversions=n_conversions)


def _flash(fabric: FabricConfig, n_conversions: int) -> ScheduleResult:
    nc = fabric.compute_arrays_per_group
    n_ref = fabric.n_ref_per_group
    slots: List[Slot] = []
    nf = [0] * nc
    bank_free = 0  # the whole reference bank serializes compare cycles
    end = 0
    for conv in range(n_conversions):
        i = conv % nc
        t = max(nf[i], bank_free - 1)
        slots.append(Slot(t, f"C{i}", "compute"))
        slots.append(Slot(t + 1, f"C{i}", "compare"))
        for r in range(n_ref):
            slots.append(Slot(t + 1, f"R{r}", "flash_ref"))
        nf[i] = t + 2
        bank_free = t + 2
        end = max(end, t + 2)
    return ScheduleResult(slots, end, n_conversions, nc + n_ref)


def _hybrid(fabric: FabricConfig, n_conversions: int) -> ScheduleResult:
    """Wave-pipelined Fig. 3: all compute arrays evaluate together, take
    staggered turns on the shared flash bank (one compare cycle each — a
    reference array cannot hold flash references while ramping a SAR
    ref-gen), then pair off with reference arrays for parallel SAR tails.
    Computing arrays hold V_MAV from compute until their SAR completes, so
    the next wave starts only after the tails drain."""
    bits, f = fabric.adc_bits, fabric.flash_bits
    nc = fabric.compute_arrays_per_group
    n_ref = fabric.n_ref_per_group
    sar = bits - f
    slots: List[Slot] = []
    t = 0
    done = 0
    while done < n_conversions:
        wave = min(nc, n_conversions - done)
        for i in range(wave):
            slots.append(Slot(t, f"C{i}", "compute"))
        for i in range(wave):  # staggered flash compares, one bank turn each
            slots.append(Slot(t + 1 + i, f"C{i}", "compare"))
            for j in range(n_ref):
                slots.append(Slot(t + 1 + i, f"R{j}", "flash_ref"))
        # SAR tails in parallel across distinct reference arrays; if the wave
        # outnumbers the bank, tails run in ceil(wave/n_ref) serial batches
        sar_start = t + 1 + wave
        batches = -(-wave // n_ref)
        for i in range(wave):
            b, r = divmod(i, n_ref)
            for c in range(sar_start + b * sar, sar_start + (b + 1) * sar):
                slots.append(Slot(c, f"C{i}", "hold"))
                slots.append(Slot(c, f"R{r}", "ref_gen"))
        t = sar_start + batches * sar
        done += wave
    return ScheduleResult(slots, t, n_conversions, nc + n_ref)


def _conventional(fabric: FabricConfig, n_conversions: int) -> ScheduleResult:
    """Dedicated sample-and-hold ADC: compute overlaps the previous
    conversion; throughput limited by max(1, ADC latency)."""
    lat = 1 if fabric.mode == "conventional_flash" else fabric.adc_bits
    slots: List[Slot] = []
    t = 0
    for conv in range(n_conversions):
        slots.append(Slot(t, "A0", "compute"))
        for c in range(t + 1, t + 1 + lat):
            slots.append(Slot(c, "A0", "adc"))  # off-array ADC busy, array free
        t += max(1, lat)
    end = (n_conversions - 1) * max(1, lat) + 1 + lat  # last ADC drain
    return ScheduleResult(slots, end, n_conversions, 1)


_SCHEDULERS = {
    "pair_sar": _pair_sar,
    "flash": _flash,
    "hybrid": _hybrid,
    "conventional_sar": _conventional,
    "conventional_flash": _conventional,
}


def pipelined_schedule(fabric: FabricConfig, n_conversions: int = 32) -> ScheduleResult:
    """Steady-state schedule of ``n_conversions`` on ONE digitization group.

    Example::

        >>> from repro_torch.fabric import FabricConfig, pipelined_schedule
        >>> s = pipelined_schedule(FabricConfig(mode="pair_sar", adc_bits=5, n_arrays=2), 8)
        >>> s.n_conversions, s.n_cycles > 0
        (8, True)
    """
    return _SCHEDULERS[fabric.mode](fabric, n_conversions)


def fabric_throughput(fabric: FabricConfig, n_conversions: int = 96) -> dict:
    """Chip-level steady-state throughput and utilization.

    Example::

        >>> from repro_torch.fabric import FabricConfig, fabric_throughput
        >>> tp = fabric_throughput(FabricConfig(mode="hybrid", n_arrays=60))
        >>> tp["n_groups"], tp["chip_conversions_per_cycle"] > 0
        (10, True)
    """
    sched = pipelined_schedule(fabric, n_conversions)
    group_rate = sched.n_conversions / sched.n_cycles
    n_groups = fabric.n_groups
    per_array = group_rate / fabric.group_size
    chip_rate = group_rate * n_groups
    return {
        "mode": fabric.mode,
        "n_arrays": fabric.resolved_n_arrays(),
        "n_groups": n_groups,
        "group_conversions_per_cycle": group_rate,
        "conversions_per_cycle_per_array": per_array,
        "chip_conversions_per_cycle": chip_rate,
        "chip_conversions_per_s": chip_rate * fabric.freq_hz,
        "compute_utilization": sched.utilization("compute"),
        "chip_area_um2": fabric.chip_area_um2(),
        "throughput_per_mm2": chip_rate / (fabric.chip_area_um2() / 1e6),
    }


def overlap_rounds(compute_s: Sequence[float], link_s: Sequence[float]) -> float:
    """Total latency of double-buffered mesh rounds: the cross-chip
    reduce-scatter of layer ``i`` runs on the links while layer ``i+1``'s
    conversions are already in flight on the arrays (the partial-sum buffer
    is double-buffered, so the arrays never wait for the links unless a
    reduce-scatter outlasts the next layer's conversion schedule).

    ``compute_s[i]`` is layer i's conversion time, ``link_s[i]`` its
    reduce-scatter link time; returns the pipelined end-to-end seconds:
    ``compute_0 + sum(max(compute_i, link_{i-1})) + link_last``.

    Example::

        >>> overlap_rounds([1.0, 1.0, 1.0], [0.5, 0.5, 0.5])  # links fully hidden
        3.5
        >>> overlap_rounds([1.0, 1.0], [2.0, 0.0])  # link outlasts next layer
        3.0
    """
    if len(compute_s) != len(link_s):
        raise ValueError("compute_s and link_s must align layer-for-layer")
    if not compute_s:
        return 0.0
    t = compute_s[0]
    for i in range(1, len(compute_s)):
        t += max(compute_s[i], link_s[i - 1])
    return t + link_s[-1]


def overlapped_mesh_latency(sharded: Sequence, n_conversions: int = 96) -> dict:
    """Mesh latency with layer ``i``'s reduce-scatter overlapping layer
    ``i+1``'s conversions (see :func:`overlap_rounds`), for a list of
    :class:`~repro_torch.fabric.shard.ShardedPlacement` layers.

    Returns serial vs overlapped end-to-end seconds plus how much link time
    the overlap hides — the number ``sharded_fabric_report`` folds into its
    totals.

    Example::

        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, map_matmul, shard_placement
        >>> fb = FabricConfig(mode="pair_sar", n_arrays=8)
        >>> cm = ChipMeshConfig(model=2, fabric=fb)
        >>> sps = [shard_placement(map_matmul(f"l{i}", 4, 64, 64, fb), cm) for i in range(3)]
        >>> r = overlapped_mesh_latency(sps)
        >>> 0 < r["overlapped_latency_s"] <= r["serial_latency_s"]
        True
    """
    if not sharded:
        return {
            "serial_latency_s": 0.0,
            "overlapped_latency_s": 0.0,
            "hidden_link_s": 0.0,
            "link_hidden_fraction": 0.0,
        }
    fabric = sharded[0].chip_mesh.fabric
    tp = fabric_throughput(fabric, n_conversions)
    rate_per_compute = tp["group_conversions_per_cycle"] / fabric.compute_arrays_per_group
    compute = [conversion_cycles(sp.chip, rate_per_compute) / fabric.freq_hz for sp in sharded]
    link = [sp.crosschip_latency_s for sp in sharded]
    serial = sum(compute) + sum(link)
    overlapped = overlap_rounds(compute, link)
    hidden = serial - overlapped
    total_link = sum(link)
    # hidden == sum(min(compute_i, link_{i-1})) lies in [0, total_link] by
    # construction; the clamp only guards float subtraction slop at the
    # link >= compute boundary (everything hidden) and the zero-link end
    fraction = min(1.0, max(0.0, hidden / total_link)) if total_link > 0 else 0.0
    return {
        "serial_latency_s": serial,
        "overlapped_latency_s": overlapped,
        "hidden_link_s": hidden,
        "link_hidden_fraction": fraction,
    }


def link_validation(sharded: Sequence, measured_collective_s: Optional[float], n_conversions: int = 96) -> dict:
    """Measured-vs-modeled link latency for one forward pass — the
    validation loop the fused program closes.

    ``measured_collective_s`` is the fused program's collective time
    (``fabric.program.measure_forward``: fused minus collective-stripped,
    host clock around synchronized device work); the modeled side is
    :func:`overlapped_mesh_latency`'s prediction in fabric seconds (10 MHz
    conversion clock, ``link_bits_per_s`` links). The two clock domains
    differ, so their ratio is a *clock-domain calibration constant* — the
    ``link_clock_calibration`` key (``measured_over_modeled`` is its alias)
    — never expected to be 1; ``None`` when the mesh has no links or nothing
    was measured. When ``repro_torch.obs`` metrics collection is active the
    three land on the ``fabric_modeled_link_seconds`` /
    ``fabric_measured_collective_seconds`` / ``fabric_link_clock_calibration``
    gauges.

    Example::

        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, map_matmul, shard_placement
        >>> fb = FabricConfig(mode="pair_sar", n_arrays=8)
        >>> cm = ChipMeshConfig(model=2, fabric=fb)
        >>> sps = [shard_placement(map_matmul(f"l{i}", 4, 64, 64, fb), cm) for i in range(2)]
        >>> v = link_validation(sps, measured_collective_s=1e-3)
        >>> v["modeled_link_s"] > 0 and v["link_clock_calibration"] > 0
        True
    """
    from repro_torch.obs import metrics as obs_metrics

    ov = overlapped_mesh_latency(sharded, n_conversions)
    modeled = sum(sp.crosschip_latency_s for sp in sharded)
    ratio = (
        measured_collective_s / modeled
        if measured_collective_s is not None and modeled > 0
        else None
    )
    obs_metrics.set_gauge(
        "fabric_modeled_link_seconds", modeled,
        help="Modeled reduce-scatter link time per forward pass (fabric clock).",
    )
    if measured_collective_s is not None:
        obs_metrics.set_gauge(
            "fabric_measured_collective_seconds", measured_collective_s,
            help="Measured fused-minus-local collective wall time (host clock).",
        )
    if ratio is not None:
        obs_metrics.set_gauge(
            "fabric_link_clock_calibration", ratio,
            help="Clock-domain calibration constant: measured host seconds / "
            "modeled fabric-clock link seconds.",
        )
    return {
        "modeled_link_s": modeled,
        "modeled_serial_latency_s": ov["serial_latency_s"],
        "modeled_overlapped_latency_s": ov["overlapped_latency_s"],
        "modeled_hidden_link_s": ov["hidden_link_s"],
        "modeled_link_hidden_fraction": ov["link_hidden_fraction"],
        "measured_collective_s": measured_collective_s,
        "link_clock_calibration": ratio,
        "measured_over_modeled": ratio,
    }


def iso_area_comparison(fabric: FabricConfig, n_conversions: int = 96) -> dict:
    """In-memory fabric vs the conventional-ADC fabric of equal chip area.

    The returned ``throughput_ratio`` >= 1 is the paper's recovery claim:
    cheap digitization buys more arrays than the collaborative duty-cycle
    loss costs (holds for pair_sar and hybrid against the dedicated-SAR
    baseline; one-to-many flash coupling trades throughput density for its
    ~51x ADC area and ~13x energy advantages).

    Example::

        >>> from repro_torch.fabric import FabricConfig, iso_area_comparison
        >>> iso = iso_area_comparison(FabricConfig(mode="pair_sar", n_arrays=120))
        >>> iso["throughput_ratio"] >= 1.0 and iso["adc_area_ratio"] > 24
        True
    """
    conv = fabric.iso_area_counterpart()
    mine = fabric_throughput(fabric, n_conversions)
    theirs = fabric_throughput(conv, n_conversions)
    return {
        "in_memory": mine,
        "conventional": theirs,
        "adc_area_ratio": conv.digitizer_area_um2 / fabric.digitizer_area_um2,
        "array_count_ratio": mine["n_arrays"] / theirs["n_arrays"],
        "throughput_ratio": mine["chip_conversions_per_cycle"]
        / theirs["chip_conversions_per_cycle"],
    }
