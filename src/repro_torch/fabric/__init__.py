"""Chip-level collaborative CiM fabric (paper Figs. 1-3, 5c, Table I), one chip.

The PyTorch counterpart of ``repro.fabric``'s single-chip stack:

  * :mod:`repro_torch.fabric.topology` — ``FabricConfig``: a grid of CiM
    arrays wired as one of the paper's networking configurations
    (``pair_sar`` / ``flash`` / ``hybrid``) or a conventional dedicated-ADC
    baseline, sized by count or by an area budget (``core.energy_area``).
  * :mod:`repro_torch.fabric.mapper` — tile a matmul (or a whole
    ``ModelConfig``) onto the fabric: K across arrays at ``rows``
    boundaries, N across array columns, M across time; placements with
    weight-load (external-memory-access) counts.
  * :mod:`repro_torch.fabric.pipeline` — cycle-pipelined schedules over a
    digitization group; chip throughput and the iso-area comparison.
  * :mod:`repro_torch.fabric.tiles` — the per-column-tile inner loop with
    its per-tile noise keys, and the analytic ``fake_quant`` stats.
  * :mod:`repro_torch.fabric.execute` — numerical execution of a mapped
    placement: ``fake_quant`` one CiM fake-quant kernel launch per column
    tile on the card, ``bitplane`` the faithful per-plane path.
  * :mod:`repro_torch.fabric.report` — per-layer and chip-level area /
    energy / latency / EMA rollups and their markdown.

Everything equals the JAX package's results on the CPU (dicts, markdown,
placements, outputs; noisy draws included). Sharding across chips, the fused
forward program and graph, and the autotuner wait for their ports
(ROADMAP.md, port queues A6-A8).
"""

from repro_torch.fabric.execute import execute_linear, execute_matmul
from repro_torch.fabric.mapper import LayerPlacement, TileAssignment, map_matmul, map_model, model_matmuls
from repro_torch.fabric.pipeline import (
    conversion_cycles,
    fabric_throughput,
    iso_area_comparison,
    overlap_rounds,
    pipelined_schedule,
)
from repro_torch.fabric.report import fabric_report, render_markdown
from repro_torch.fabric.tiles import analytic_cim_stats, column_tile_matmul
from repro_torch.fabric.topology import BITCELL_UM2_65NM, MODES, ChipMeshConfig, FabricConfig, arrays_for_area

__all__ = [
    "FabricConfig",
    "ChipMeshConfig",
    "MODES",
    "BITCELL_UM2_65NM",
    "arrays_for_area",
    "TileAssignment",
    "LayerPlacement",
    "map_matmul",
    "map_model",
    "model_matmuls",
    "conversion_cycles",
    "fabric_throughput",
    "iso_area_comparison",
    "overlap_rounds",
    "pipelined_schedule",
    "column_tile_matmul",
    "analytic_cim_stats",
    "execute_matmul",
    "execute_linear",
    "fabric_report",
    "render_markdown",
]
