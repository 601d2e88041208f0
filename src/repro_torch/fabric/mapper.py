"""Map matmuls / whole models onto a CiM fabric.

One weight tile is ``rows x cols`` of the (quantized) weight matrix — exactly
one array's stored plane set. A matmul ``(M, K) @ (K, N)`` therefore shatters
into ``ceil(K/rows) * ceil(N/cols)`` tiles: K is split *across arrays* (each
array holds one reduction slice on its word lines), N across array columns,
and M streams *across time* (every input row visits each resident tile).

Tiles are assigned round-robin to the fabric's compute arrays. When a layer
(or model) has more tiles than compute arrays, arrays process their tiles in
sequential *rounds* and every tile's weights must be (re)loaded from external
memory each pass — the weight-load counts here are the paper's external
memory access (EMA) argument: an iso-area in-memory fabric holds more arrays,
so more tiles stay resident and EMA drops.

Digitization counts follow ``core.cim_linear.digitization_stats``: each
(input-plane x weight-plane) pair of each (m, k-tile, output-column) triple is
one analog-to-digital conversion.

The PyTorch counterpart of ``repro.fabric.mapper``, with the forward chain
(``model_forward_chain``) that ``fabric.program`` fuses. The forward graph
(``GraphNode``, ``ForwardGraph``, ``model_forward_graph``,
``model_block_template``) waits for the port of the fused graph executor
(ROADMAP.md, port queue A7).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cim_linear import CiMConfig
from repro_torch.fabric.topology import FabricConfig

__all__ = ["TileAssignment", "LayerPlacement", "map_matmul", "map_model", "model_matmuls", "model_forward_chain"]


@dataclasses.dataclass(frozen=True)
class TileAssignment:
    """One rows x cols weight tile placed on one compute array."""

    k_tile: int
    n_tile: int
    array: int  # compute-array index on the fabric
    round: int  # sequential pass in which this array processes the tile
    k0: int
    k1: int
    n0: int
    n1: int


@dataclasses.dataclass
class LayerPlacement:
    """Placement of one matmul on the fabric, plus its cost counters.

    Example::

        >>> from repro_torch.fabric import FabricConfig, map_matmul
        >>> p = map_matmul("l", m=4, k=64, n=64, fabric=FabricConfig(mode="pair_sar", n_arrays=8))
        >>> p.k_tiles, p.n_tiles, p.rounds, p.resident
        (4, 2, 1, True)
    """

    name: str
    m: int
    k: int
    n: int
    fabric: FabricConfig
    cim: CiMConfig
    tiles: List[TileAssignment]
    k_tiles: int
    n_tiles: int
    rounds: int

    @property
    def n_weight_tiles(self) -> int:
        return self.k_tiles * self.n_tiles

    @property
    def resident(self) -> bool:
        """All of THIS layer's tiles fit on the compute arrays at once
        (single round). Layer-local only: steady-state reload-free operation
        additionally needs the whole model resident (``fabric_report``)."""
        return self.rounds == 1

    @property
    def weight_load_bits(self) -> int:
        """External-memory bits fetched to program the tiles once."""
        return self.n_weight_tiles * self.fabric.rows * self.fabric.cols * self.cim.w_bits

    @property
    def activation_bits(self) -> int:
        """Input activation bits streamed in (each m-row visits every k-tile
        once per n-round it participates in; broadcast across an array's cols)."""
        return self.m * self.k * self.cim.a_bits

    @property
    def conversions(self) -> int:
        """Total ADC conversions (plane-pair x m x k-tile x output column)."""
        return self.cim.a_bits * self.cim.w_bits * self.m * self.k_tiles * self.n

    @property
    def conversions_per_array_max(self) -> int:
        """Conversions on the busiest compute array (sets layer latency)."""
        per_array: dict[int, int] = {}
        ab = self.cim.a_bits * self.cim.w_bits * self.m
        for t in self.tiles:
            per_array[t.array] = per_array.get(t.array, 0) + ab * (t.n1 - t.n0)
        return max(per_array.values())

    def stats(self) -> dict:
        return {
            "layer": self.name,
            "m": self.m,
            "k": self.k,
            "n": self.n,
            "tiles": self.n_weight_tiles,
            "rounds": self.rounds,
            "resident": self.resident,
            "weight_load_bits": self.weight_load_bits,
            "activation_bits": self.activation_bits,
            "conversions": self.conversions,
        }


def map_matmul(
    name: str,
    m: int,
    k: int,
    n: int,
    fabric: FabricConfig,
    cim: Optional[CiMConfig] = None,
    array_offset: int = 0,
) -> LayerPlacement:
    """Tile an (M, K) @ (K, N) matmul onto the fabric's compute arrays.

    ``array_offset`` rotates the round-robin start so consecutive layers of a
    model spread across the chip instead of piling onto array 0.

    Example::

        >>> from repro_torch.fabric import FabricConfig, map_matmul
        >>> p = map_matmul("q_proj", m=1, k=40, n=70, fabric=FabricConfig(mode="pair_sar", n_arrays=8))
        >>> (p.k_tiles, p.n_tiles), len(p.tiles), p.rounds
        ((3, 3), 9, 2)
    """
    if cim is None:
        cim = CiMConfig(mode="bitplane", adc_bits=fabric.adc_bits, rows=fabric.rows, ste=False)
    if cim.rows != fabric.rows:
        raise ValueError(f"cim.rows={cim.rows} != fabric.rows={fabric.rows}")
    r, c = fabric.rows, fabric.cols
    k_tiles = math.ceil(k / r)
    n_tiles = math.ceil(n / c)
    n_compute = fabric.n_compute_arrays

    tiles: List[TileAssignment] = []
    idx = 0
    for nt in range(n_tiles):
        for kt in range(k_tiles):
            slot = (array_offset + idx) % n_compute
            tiles.append(
                TileAssignment(
                    k_tile=kt,
                    n_tile=nt,
                    array=slot,
                    round=idx // n_compute,
                    k0=kt * r,
                    k1=min((kt + 1) * r, k),
                    n0=nt * c,
                    n1=min((nt + 1) * c, n),
                )
            )
            idx += 1
    rounds = math.ceil(idx / n_compute)
    return LayerPlacement(
        name=name, m=m, k=k, n=n, fabric=fabric, cim=cim,
        tiles=tiles, k_tiles=k_tiles, n_tiles=n_tiles, rounds=rounds,
    )


# ---------------------------------------------------------------------------
# Model-level mapping
# ---------------------------------------------------------------------------


def model_matmuls(
    cfg: ModelConfig, tokens: int, block_only: bool = False
) -> List[Tuple[str, int, int, int]]:
    """The (name, M, K, N) linear shapes of one forward pass.

    ``block_only`` restricts to a single attention+MLP block (the
    ``examples/fabric_map.py`` workload of the JAX package); otherwise all ``n_layers`` layers
    plus the unembedding are included. MoE counts the ``top_k`` activated
    experts; Mamba/hybrid families map their projection matmuls.

    Example::

        >>> from repro_torch.configs.registry import get_config
        >>> from repro_torch.fabric import model_matmuls
        >>> [name for name, *_ in model_matmuls(get_config("smollm-135m"), 4, block_only=True)][:2]
        ['block.q_proj', 'block.k_proj']
    """
    d = cfg.d_model
    out: List[Tuple[str, int, int, int]] = []

    def attn(prefix: str):
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        out.append((f"{prefix}.q_proj", tokens, d, h * hd))
        out.append((f"{prefix}.k_proj", tokens, d, kv * hd))
        out.append((f"{prefix}.v_proj", tokens, d, kv * hd))
        out.append((f"{prefix}.o_proj", tokens, h * hd, d))

    def mlp(prefix: str, d_ff: int):
        out.append((f"{prefix}.gate_proj", tokens, d, d_ff))
        out.append((f"{prefix}.up_proj", tokens, d, d_ff))
        out.append((f"{prefix}.down_proj", tokens, d_ff, d))

    def moe(prefix: str):
        out.append((f"{prefix}.router", tokens, d, cfg.n_experts))
        for e in range(cfg.top_k):  # activated experts (per-token top_k)
            mlp(f"{prefix}.expert{e}", cfg.d_ff_expert)

    def mamba(prefix: str):
        di, ns, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        out.append((f"{prefix}.in_proj", tokens, d, 2 * di + 2 * ns + h))
        out.append((f"{prefix}.out_proj", tokens, di, d))

    if block_only:
        if cfg.family in ("dense", "moe", "hybrid"):
            attn("block")
        if cfg.family == "moe":
            moe("block")
        elif cfg.family == "mamba":
            mamba("block")
        else:
            mlp("block", cfg.d_ff or cfg.d_model * 4)
        return out

    for i in range(cfg.n_layers):
        p = f"layer{i}"
        if cfg.family == "dense":
            attn(p)
            mlp(p, cfg.d_ff)
        elif cfg.family == "moe":
            attn(p)
            moe(p)
        elif cfg.family == "mamba":
            mamba(p)
        elif cfg.family == "hybrid":
            mamba(p)
            if cfg.share_period and i % cfg.share_period == 0:
                attn(f"{p}.shared_attn")
                mlp(f"{p}.shared_attn", cfg.d_ff)
        else:
            raise ValueError(cfg.family)
    out.append(("unembed", tokens, d, cfg.padded_vocab))
    return out


def model_forward_chain(
    cfg: ModelConfig, tokens: int, block_only: bool = False
) -> List[Tuple[str, int, int, int]]:
    """The maximal *chained* subset of :func:`model_matmuls`: starting from
    the ``d_model`` residual stream, keep every matmul whose K equals the
    previous kept matmul's N — the linears on the forward critical path,
    where layer i's output IS layer i+1's input.

    This is the workload ``fabric.program.compile_forward`` fuses. Sibling
    projections that branch off the residual stream rather than continue it
    (``k_proj`` / ``v_proj`` / ``up_proj`` / the MoE ``router``) are skipped
    even when their K happens to match, and MoE keeps only ``expert0`` — a
    token's critical path runs through ONE activated expert. A dense
    transformer therefore chains ``q_proj -> o_proj -> gate_proj ->
    down_proj`` per layer plus the unembed; families whose residual path is
    not a pure matmul chain (Mamba's ``in_proj -> SSM -> out_proj``) yield
    shorter chains.

    Example::

        >>> from repro_torch.configs.registry import get_config
        >>> from repro_torch.fabric import model_forward_chain
        >>> [n for n, *_ in model_forward_chain(get_config("smollm-135m"), 4, block_only=True)]
        ['block.q_proj', 'block.o_proj', 'block.gate_proj', 'block.down_proj']
    """
    siblings = ("k_proj", "v_proj", "up_proj", "router")
    chain: List[Tuple[str, int, int, int]] = []
    cur = cfg.d_model
    for name, m, k, n in model_matmuls(cfg, tokens, block_only=block_only):
        parts = name.split(".")
        if parts[-1] in siblings:
            continue
        if any(p.startswith("expert") and p != "expert0" for p in parts):
            continue  # parallel experts: only one is on a token's critical path
        if k == cur:
            chain.append((name, m, k, n))
            cur = n
    return chain


def map_model(
    cfg: ModelConfig,
    fabric: FabricConfig,
    tokens: int = 1,
    cim: Optional[CiMConfig] = None,
    block_only: bool = False,
) -> List[LayerPlacement]:
    """Place every linear of ``cfg`` onto the fabric (round-robin across
    layers so the chip fills evenly).

    Example::

        >>> from repro_torch.configs.registry import get_config
        >>> from repro_torch.fabric import FabricConfig, map_model
        >>> ps = map_model(get_config("smollm-135m"), FabricConfig(mode="hybrid", n_arrays=60),
        ...                tokens=4, block_only=True)
        >>> len(ps), ps[0].name
        (7, 'block.q_proj')
    """
    placements: List[LayerPlacement] = []
    offset = 0
    for name, m, k, n in model_matmuls(cfg, tokens, block_only=block_only):
        p = map_matmul(name, m, k, n, fabric, cim=cim, array_offset=offset)
        offset = (offset + p.n_weight_tiles) % fabric.n_compute_arrays
        placements.append(p)
    return placements
