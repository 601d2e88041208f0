"""Fabric topology: a chip of CiM arrays under one networking configuration.

A fabric is a grid of identical ``rows x cols`` bit-plane CiM arrays
(``core.cim_array``) partitioned into *digitization groups* — the paper's
networking neighborhoods (Fig. 1):

  * ``pair_sar``          — arrays pair up; partners alternate compute /
                            reference-generation roles each conversion (Fig. 2).
  * ``flash``             — a bank of 2^bits - 1 reference arrays serves
                            ``n_cim_per_group`` compute arrays; one comparison
                            cycle per conversion (Fig. 1 right).
  * ``hybrid``            — ``n_cim_per_group`` compute arrays take staggered
                            turns on a shared 2^flash_bits - 1 flash bank for
                            their MSBs, then pair off for SAR on the remaining
                            bits (Fig. 3, 5c).
  * ``conventional_sar``  — baseline: every array owns a dedicated SAR ADC
                            (40 nm anchor, Table I); no arrays are spent on
                            reference generation.
  * ``conventional_flash``— baseline with a dedicated Flash ADC per array.

The PyTorch counterpart of ``repro.fabric.topology``. Area accounting is
anchored to ``core.energy_area`` (Table I): the in-memory
digitizer costs ~207.8 um^2 per array vs 5235.2 (SAR) / 10703.4 (Flash), which
is what lets an iso-area in-memory fabric pack ~25x/~51x cheaper digitization
and therefore more arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.energy_area import area_um2

__all__ = [
    "FabricConfig",
    "ChipMeshConfig",
    "arrays_for_area",
    "MODES",
    "BITCELL_UM2_65NM",
]

MODES = ("pair_sar", "flash", "hybrid", "conventional_sar", "conventional_flash")

# 65 nm 8T compute-SRAM bitcell (~1.9 um^2) plus ~15% periphery (WL/IL drivers,
# precharge, transmission gates) — the bare array cost one digitizer rides on.
BITCELL_UM2_65NM = 1.9
_PERIPHERY_FACTOR = 1.15

# External-memory (weight reload) energy anchor, pJ per bit (LPDDR-class).
EMA_PJ_PER_BIT = 10.0


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Static description of one chip-level CiM fabric.

    A grid of ``rows x cols`` bit-plane CiM arrays partitioned into
    digitization groups under one networking ``mode`` (see module docstring);
    sized either by an explicit ``n_arrays`` or an ``area_budget_um2``
    (whole groups only).

    Example::

        >>> fb = FabricConfig(mode="hybrid", adc_bits=5, flash_bits=2, n_arrays=64)
        >>> fb.group_size, fb.resolved_n_arrays(), fb.n_compute_arrays
        (6, 60, 30)
    """

    mode: str = "hybrid"
    rows: int = 16  # word lines per array (reduction-tile size)
    cols: int = 32  # columns per array (output channels per tile)
    adc_bits: int = 5
    flash_bits: int = 2  # MSBs on the shared flash bank (hybrid only)
    n_cim_per_group: int = 3  # compute arrays sharing one reference bank
    n_arrays: Optional[int] = None  # explicit total array count
    area_budget_um2: Optional[float] = None  # derive n_arrays from a budget
    freq_hz: float = 10e6  # conversion-cycle clock (Table I anchor)
    vdd: float = 1.0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown fabric mode {self.mode!r}; pick from {MODES}")
        if self.mode == "hybrid" and not (0 < self.flash_bits < self.adc_bits):
            raise ValueError("hybrid mode needs 0 < flash_bits < adc_bits")
        if self.n_cim_per_group < 1:
            raise ValueError("n_cim_per_group must be >= 1")
        if self.n_arrays is None and self.area_budget_um2 is None:
            object.__setattr__(self, "n_arrays", 64)
        if self.n_arrays is not None and self.n_arrays < self.group_size:
            raise ValueError(
                f"need at least one full group ({self.group_size} arrays), "
                f"got n_arrays={self.n_arrays}"
            )

    # -- group structure ----------------------------------------------------

    @property
    def n_ref_per_group(self) -> int:
        """Arrays per group spent generating references (not computing)."""
        if self.mode == "pair_sar":
            return 0  # partners swap roles; both compute at half duty
        if self.mode == "flash":
            return (1 << self.adc_bits) - 1
        if self.mode == "hybrid":
            return (1 << self.flash_bits) - 1
        return 0  # conventional: dedicated ADC, no arrays stolen

    @property
    def compute_arrays_per_group(self) -> int:
        if self.mode == "pair_sar":
            return 2
        if self.mode.startswith("conventional"):
            return 1
        return self.n_cim_per_group

    @property
    def group_size(self) -> int:
        return self.compute_arrays_per_group + self.n_ref_per_group

    # -- sizing -------------------------------------------------------------

    @property
    def adc_style(self) -> str:
        """core.energy_area style for this fabric's digitizer."""
        return {
            "pair_sar": "in_memory",
            "flash": "in_memory_flash",
            "hybrid": "in_memory_hybrid",
            "conventional_sar": "sar",
            "conventional_flash": "flash",
        }[self.mode]

    @property
    def array_area_um2(self) -> float:
        return self.rows * self.cols * BITCELL_UM2_65NM * _PERIPHERY_FACTOR

    @property
    def digitizer_area_um2(self) -> float:
        """Per-array digitization area (comparator + gates, or dedicated ADC)."""
        return area_um2(self.adc_style, self.adc_bits)

    @property
    def per_array_area_um2(self) -> float:
        return self.array_area_um2 + self.digitizer_area_um2

    def resolved_n_arrays(self) -> int:
        """Array count, floored to whole digitization groups."""
        if self.n_arrays is not None:
            n = self.n_arrays
        else:
            # epsilon guards exact-multiple budgets against fp division slop
            n = int(self.area_budget_um2 / self.per_array_area_um2 + 1e-9)
        n_groups = n // self.group_size
        if n_groups < 1:
            raise ValueError(
                f"budget fits {n} arrays < one {self.mode} group of {self.group_size}"
            )
        return n_groups * self.group_size

    @property
    def n_groups(self) -> int:
        return self.resolved_n_arrays() // self.group_size

    @property
    def n_compute_arrays(self) -> int:
        return self.n_groups * self.compute_arrays_per_group

    def chip_area_um2(self) -> float:
        return self.resolved_n_arrays() * self.per_array_area_um2

    def chip_adc_area_um2(self) -> float:
        return self.resolved_n_arrays() * self.digitizer_area_um2

    def weight_capacity_bits(self) -> int:
        """Raw weight-bit capacity of the compute arrays (one bitcell holds
        one weight-plane bit; a w_bits weight occupies w_bits cells)."""
        return self.n_compute_arrays * self.rows * self.cols

    def iso_area_counterpart(self) -> "FabricConfig":
        """The conventional-ADC fabric occupying the same chip area.

        pair_sar / hybrid compare against dedicated SAR; flash against
        dedicated Flash (the paper's two Table I baselines).
        """
        if self.mode.startswith("conventional"):
            raise ValueError("already a conventional baseline")
        base = "conventional_flash" if self.mode == "flash" else "conventional_sar"
        return dataclasses.replace(
            self,
            mode=base,
            n_arrays=None,
            area_budget_um2=self.chip_area_um2(),
        )


def arrays_for_area(budget_um2: float, fabric: FabricConfig) -> int:
    """How many arrays (whole groups) of this fabric style fit in a budget.

    Example::

        >>> fb = FabricConfig(mode="pair_sar", n_arrays=2)
        >>> arrays_for_area(10 * fb.per_array_area_um2, fb)
        10
    """
    return dataclasses.replace(
        fabric, n_arrays=None, area_budget_um2=budget_um2
    ).resolved_n_arrays()


@dataclasses.dataclass(frozen=True)
class ChipMeshConfig:
    """A mesh of identical CiM chips the fabric shards across.

    Two named axes, as the JAX package's chip meshes: ``model`` chips split a layer's
    K-parallel reduction tiles and combine their partial product-sums with a
    reduce-scatter over the inter-chip links; ``data`` chips replicate the
    weights and split the batch. ``fabric`` describes every chip (one
    :class:`FabricConfig`), so chip-local area/energy/latency roll up
    unchanged while the link parameters price the new cross-chip traffic
    that a sharded report prices separately from on-chip EMA
    (``fabric.shard``, ``fabric.program``). In the port every chip of the
    mesh runs on one torch device.

    Example::

        >>> cm = ChipMeshConfig(data=2, model=2, fabric=FabricConfig(mode="hybrid"))
        >>> cm.n_chips
        4
    """

    data: int = 1  # batch-parallel chips (weights replicated)
    model: int = 1  # K-parallel chips (partial sums reduce-scattered)
    fabric: FabricConfig = FabricConfig()
    link_bits_per_s: float = 32e9  # per-chip inter-chip link bandwidth
    link_pj_per_bit: float = 1.0  # SerDes-class link energy
    psum_bits: int = 24  # partial-sum word width on the links

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(
                f"mesh axes must be >= 1, got data={self.data}, model={self.model}"
            )
        if self.psum_bits < 1:
            raise ValueError("psum_bits must be >= 1")

    @property
    def n_chips(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> tuple:
        return (self.data, self.model)

    def mesh(self):
        """The shape-only ``(data, model)`` chip mesh
        (``launch.mesh.make_chip_mesh``)."""
        from repro_torch.launch.mesh import make_chip_mesh

        return make_chip_mesh(self.data, self.model)

    def total_area_um2(self) -> float:
        return self.n_chips * self.fabric.chip_area_um2()

    def total_weight_capacity_bits(self) -> int:
        """Distinct weight bits the mesh can hold resident: ``model`` chips
        hold different K-slices, ``data`` chips hold copies."""
        return self.model * self.fabric.weight_capacity_bits()
