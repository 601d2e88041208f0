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
    weight-load (external-memory-access) counts; the model's forward chain
    and its forward graph (every matmul and the mixing ops between them).
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
  * :mod:`repro_torch.fabric.graph` — the fused forward over whole
    transformer blocks (``compile_graph_forward`` -> ``GraphProgram``:
    siblings, attention, norms, residuals; the scan form over stacked
    layer weights), its per-node reference loop and weight adapters.
  * :mod:`repro_torch.fabric.autotune` — the bucketed program cache for
    ragged batches and the cost-model mesh/bucket autotuner.
  * :mod:`repro_torch.fabric.report` — per-layer and chip- or mesh-level
    area / energy / latency / EMA rollups and their markdown.

Plans, dicts and markdown equal the JAX package's on the CPU, and so do the
CiM outputs (noisy draws included); the forward graph's mixing ops (softmax,
norms, SiLU) follow torch's ``exp`` / ``rsqrt``, so its logits agree with the
JAX package's within float32 rounding.
"""

from repro_torch.fabric.autotune import (
    AutotunePlan,
    BucketedGraphCache,
    autotune_plan,
    autotune_section,
    request_histogram,
)
from repro_torch.fabric.execute import execute_linear, execute_matmul
from repro_torch.fabric.graph import (
    GraphProgram,
    compile_graph_forward,
    graph_eligibility,
    per_node_forward,
    shard_forward_graph,
    stack_block_weights,
    transformer_graph_weights,
    unstack_block_weights,
)
from repro_torch.fabric.mapper import (
    ForwardGraph,
    GraphNode,
    LayerPlacement,
    TileAssignment,
    map_matmul,
    map_model,
    model_block_template,
    model_forward_chain,
    model_forward_graph,
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
from repro_torch.fabric.report import fabric_report, graph_section, render_markdown, sharded_fabric_report
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
    "GraphNode",
    "ForwardGraph",
    "model_forward_graph",
    "model_block_template",
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
    "GraphProgram",
    "compile_graph_forward",
    "per_node_forward",
    "graph_eligibility",
    "shard_forward_graph",
    "transformer_graph_weights",
    "stack_block_weights",
    "unstack_block_weights",
    "fabric_report",
    "sharded_fabric_report",
    "graph_section",
    "render_markdown",
    "BucketedGraphCache",
    "AutotunePlan",
    "autotune_plan",
    "autotune_section",
    "request_histogram",
]
