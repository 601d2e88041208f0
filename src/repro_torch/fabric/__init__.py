"""Chip-level collaborative CiM fabric (paper Figs. 1-3, 5c, Table I), one
chip or a mesh of chips.

The PyTorch counterpart of ``repro.fabric``:

  * :mod:`repro_torch.fabric.topology` — ``FabricConfig``: a grid of CiM
    arrays wired as one of the paper's networking configurations
    (``pair_sar`` / ``flash`` / ``hybrid``) or a conventional dedicated-ADC
    baseline, sized by count or by an area budget (``core.energy_area``);
    ``ChipMeshConfig``: a ``(data, model)`` mesh of such chips.
  * :mod:`repro_torch.fabric.mapper` — tile a matmul (or a whole
    ``ModelConfig``) onto the fabric: K across arrays at ``rows``
    boundaries, N across array columns, M across time; placements with
    weight-load (external-memory-access) counts; the model's forward chain.
  * :mod:`repro_torch.fabric.pipeline` — cycle-pipelined schedules over a
    digitization group; chip throughput and the iso-area comparison; the
    mesh's double-buffered link overlap and link validation.
  * :mod:`repro_torch.fabric.tiles` — the per-column-tile inner loop with
    its per-tile noise keys, and the analytic ``fake_quant`` stats.
  * :mod:`repro_torch.fabric.execute` — numerical execution of a mapped
    placement: ``fake_quant`` one CiM fake-quant kernel launch per column
    tile on the card, ``bitplane`` the faithful per-plane path.
  * :mod:`repro_torch.fabric.shard` — shard placements across a chip mesh
    (K-parallel tiles over ``model``, batch over ``data``, divisibility
    fallbacks recorded) and execute them, every chip on one device in one
    chip loop, whichever of the JAX package's backend names is resolved.
  * :mod:`repro_torch.fabric.program` — the fused forward over the model's
    residual chain (``compile_forward`` -> ``FabricProgram``), with
    ``measure_forward``'s measured-vs-modeled link time.
  * :mod:`repro_torch.fabric.report` — per-layer and chip- or mesh-level
    area / energy / latency / EMA rollups and their markdown.

Everything equals the JAX package's results on the CPU (dicts, markdown,
placements, outputs; noisy draws included). The fused forward graph and the
autotuner wait for their ports (ROADMAP.md, port queues A7, A8).
"""

from repro_torch.fabric.execute import execute_linear, execute_matmul
from repro_torch.fabric.mapper import (
    LayerPlacement,
    TileAssignment,
    map_matmul,
    map_model,
    model_forward_chain,
    model_matmuls,
)
from repro_torch.fabric.pipeline import (
    conversion_cycles,
    fabric_throughput,
    iso_area_comparison,
    link_validation,
    overlap_rounds,
    overlapped_mesh_latency,
    pipelined_schedule,
)
from repro_torch.fabric.program import (
    FabricProgram,
    compile_forward,
    measure_forward,
    per_layer_forward,
    program_eligibility,
)
from repro_torch.fabric.report import fabric_report, render_markdown, sharded_fabric_report
from repro_torch.fabric.shard import (
    ShardedPlacement,
    execute_sharded_matmul,
    resolve_backend,
    shard_model,
    shard_placement,
)
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
    "model_forward_chain",
    "conversion_cycles",
    "fabric_throughput",
    "iso_area_comparison",
    "overlap_rounds",
    "overlapped_mesh_latency",
    "link_validation",
    "pipelined_schedule",
    "column_tile_matmul",
    "analytic_cim_stats",
    "execute_matmul",
    "execute_linear",
    "ShardedPlacement",
    "shard_placement",
    "shard_model",
    "resolve_backend",
    "execute_sharded_matmul",
    "FabricProgram",
    "compile_forward",
    "per_layer_forward",
    "measure_forward",
    "program_eligibility",
    "fabric_report",
    "sharded_fabric_report",
    "render_markdown",
]
