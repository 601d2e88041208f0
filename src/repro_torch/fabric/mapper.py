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

The PyTorch counterpart of ``repro.fabric.mapper``: the forward chain
(``model_forward_chain``) that ``fabric.program`` fuses, and the forward
graph (``GraphNode``, ``ForwardGraph``, ``model_forward_graph``,
``model_block_template``) that ``fabric.graph`` runs.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Sequence
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cim_linear import CiMConfig
from repro_torch.fabric.topology import FabricConfig

__all__ = [
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
]


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


class TileGrid(Sequence):
    """The tiles of one placement as ``map_matmul`` lays them out (N-tile
    major, then K-tile; tile ``i`` on compute array ``(offset + i) %
    n_compute`` in round ``i // n_compute``): a read-only sequence of
    :class:`TileAssignment` that builds each tile when it is read.

    A full-width model places ~10^5 tiles a linear, and planning (the
    autotuner maps a model once per mesh and bucket) reads only their
    per-array column counts (:meth:`columns_per_array`), so no list of
    tiles is ever held.
    """

    __slots__ = ("k", "n", "rows", "cols", "k_tiles", "n_tiles", "n_compute", "offset")

    def __init__(self, k: int, n: int, rows: int, cols: int, n_compute: int, offset: int):
        self.k, self.n, self.rows, self.cols = k, n, rows, cols
        self.k_tiles, self.n_tiles = math.ceil(k / rows), math.ceil(n / cols)
        self.n_compute, self.offset = n_compute, offset

    def __len__(self) -> int:
        return self.k_tiles * self.n_tiles

    def _tile(self, i: int) -> TileAssignment:
        r, c, nc = self.rows, self.cols, self.n_compute
        nt, kt = divmod(i, self.k_tiles)
        return TileAssignment(
            k_tile=kt, n_tile=nt, array=(self.offset + i) % nc, round=i // nc,
            k0=kt * r, k1=min((kt + 1) * r, self.k), n0=nt * c, n1=min((nt + 1) * c, self.n),
        )

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._tile(j) for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        return self._tile(i)

    def __iter__(self):
        return map(self._tile, range(len(self)))

    def columns_per_array(self) -> np.ndarray:
        """Output columns each compute array holds over all its tiles (the
        sum of ``n1 - n0`` by ``array``)."""
        idx = np.arange(len(self), dtype=np.int64)
        n0 = (idx // self.k_tiles) * self.cols
        width = np.minimum(n0 + self.cols, self.n) - n0
        return np.bincount((self.offset + idx) % self.n_compute, weights=width, minlength=self.n_compute)


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
    tiles: TileGrid
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
        ab = self.cim.a_bits * self.cim.w_bits * self.m
        return ab * int(self.tiles.columns_per_array().max())

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
    n_compute = fabric.n_compute_arrays
    tiles = TileGrid(k, n, fabric.rows, fabric.cols, n_compute, array_offset)
    return LayerPlacement(
        name=name, m=m, k=k, n=n, fabric=fabric, cim=cim,
        tiles=tiles, k_tiles=tiles.k_tiles, n_tiles=tiles.n_tiles, rounds=math.ceil(len(tiles) / n_compute),
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


# ---------------------------------------------------------------------------
# Forward graph: the complete block, siblings and mixing ops included
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphNode:
    """One node of a :class:`ForwardGraph`.

    ``op`` is one of:

    * ``"matmul"`` — a CiM-mapped linear ``(M, k) @ (k, n)``. ``combine``
      says how the mesh's model axis recombines the K-slice partials:
      ``"scatter"`` (tiled reduce-scatter, output stays feature-sharded) or
      ``"psum"`` (full replicated output — only the tiny MoE router, whose
      output feeds a softmax over the whole expert axis).
    * ``"norm"`` — RMS norm over the ``d``-wide feature axis (``eps``).
    * ``"attention"`` — RoPE-free causal GQA mixing ``softmax(q kᵀ) v``
      (``n_heads`` / ``n_kv_heads`` / ``head_dim``); inputs are (q, k, v).
    * ``"silu_gate"`` — ``silu(gate) * up``; inputs are (gate, up).
    * ``"residual"`` — elementwise add of its two inputs.
    * ``"moe_gate"`` — scale the expert output by the router's softmax
      probability of the one activated expert; inputs are (expert, router).

    ``inputs`` are producer-node names; the literal name ``"x"`` is the
    graph input (the embedded residual stream).
    """

    name: str
    op: str
    inputs: Tuple[str, ...]
    k: int = 0  # matmul: reduction width
    n: int = 0  # matmul: output width
    combine: str = "scatter"  # matmul: "scatter" | "psum"
    n_heads: int = 0  # attention
    n_kv_heads: int = 0  # attention
    head_dim: int = 0  # attention
    d: int = 0  # norm: feature width
    eps: float = 1e-5  # norm


@dataclasses.dataclass(frozen=True)
class ForwardGraph:
    """A complete forward pass as a node list in execution order.

    Unlike :func:`model_forward_chain` — which keeps only the residual-path
    linears and silently drops the k/v/up/router siblings plus all mixing
    ops — a graph holds EVERY matmul of the pass (sibling branches share
    their producer's input) and the non-CiM ops between them, so both the
    cost rollups and the fused executor see the model the fabric would
    actually serve.

    Example::

        >>> from repro_torch.configs.registry import get_config
        >>> from repro_torch.fabric import model_forward_graph
        >>> g = model_forward_graph(get_config("smollm-135m"), 4, block_only=True)
        >>> [nd.name for nd in g.matmul_nodes][:3]
        ['block.q_proj', 'block.k_proj', 'block.v_proj']
        >>> sorted({nd.op for nd in g.nodes})
        ['attention', 'matmul', 'norm', 'residual', 'silu_gate']
    """

    nodes: Tuple[GraphNode, ...]
    m: int  # tokens per pass — the M of every matmul node
    d_in: int  # graph-input feature width (d_model)
    output: str  # name of the node producing the graph output

    @property
    def matmul_nodes(self) -> Tuple[GraphNode, ...]:
        return tuple(nd for nd in self.nodes if nd.op == "matmul")

    def matmuls(self) -> List[Tuple[str, int, int, int]]:
        """The ``(name, M, K, N)`` list of every CiM linear, in node order —
        feeds ``shard_model(matmuls=...)`` exactly like ``model_matmuls``."""
        return [(nd.name, self.m, nd.k, nd.n) for nd in self.matmul_nodes]

    def node(self, name: str) -> GraphNode:
        for nd in self.nodes:
            if nd.name == name:
                return nd
        raise KeyError(name)

    def weighted_nodes(self) -> Tuple[GraphNode, ...]:
        """Nodes that carry a parameter: matmuls (a ``(k, n)`` weight) and
        norms (a ``(d,)`` scale vector) — the keys of a graph weight dict."""
        return tuple(nd for nd in self.nodes if nd.op in ("matmul", "norm"))

    def sibling_names(self) -> List[str]:
        """Matmul nodes that branch off a shared input instead of continuing
        the residual chain — exactly the placements ``model_forward_chain``
        drops (the chain-vs-graph cost delta of the report regression test)."""
        chain_suffixes = ("k_proj", "v_proj", "up_proj", "router")
        return [
            nd.name for nd in self.matmul_nodes
            if nd.name.split(".")[-1] in chain_suffixes
        ]

    def collective_budget(self, model_axis: int) -> dict:
        """The documented collective census of the fused graph program on a
        ``model_axis``-wide mesh (``GraphProgram.collective_counts`` must
        equal this — scatters are enumerated per sibling, never silently
        added):

        * one tiled ``reduce_scatter`` per scatter-combined matmul (siblings
          included: a dense block pays 7 — q/k/v/o/gate/up/down — where the
          chain paid 4);
        * ONE trailing ``all_gather``;
        * one ``pmax`` per re-quantization boundary = per *distinct* matmul
          input (siblings share their producer's quantization, so q/k/v and
          gate/up cost one boundary each);
        * one ``psum`` per norm (sum of squares over the sharded feature
          axis), per psum-combined router, plus 2 for the stats totals.

        On a 1x1-model mesh the scatters/gather vanish (nothing is sharded)
        and the boundary pmaxes/psums remain as counted no-ops.
        """
        scatter = sum(1 for nd in self.matmul_nodes if nd.combine == "scatter")
        psum_mm = sum(1 for nd in self.matmul_nodes if nd.combine == "psum")
        norms = sum(1 for nd in self.nodes if nd.op == "norm")
        boundaries = len({nd.inputs[0] for nd in self.matmul_nodes})
        many = model_axis > 1
        return {
            "reduce_scatter": scatter if many else 0,
            "all_gather": 1 if many else 0,
            "pmax": boundaries,
            "psum": norms + psum_mm + 2,
            "ppermute": 0,
            "all_to_all": 0,
        }

    def block_census(self, model_axis: int) -> dict:
        """The per-iteration collective census when THIS graph is the body
        of a scan-over-layers program (``compile_graph_forward`` with
        ``scan_layers=True``): like :meth:`collective_budget` but with no
        trailing all-gather and no stats-total psums — those happen once
        after the scan, not once per block. The scanned program's census
        must equal ``block_census x n_layers`` plus the tail graph's
        ``collective_budget`` — which is, by construction, exactly the
        unrolled full graph's ``collective_budget``.
        """
        b = self.collective_budget(model_axis)
        return {**b, "all_gather": 0, "psum": b["psum"] - 2}


def model_forward_graph(
    cfg: ModelConfig, tokens: int, block_only: bool = False
) -> ForwardGraph:
    """The COMPLETE forward pass of ``cfg`` as a :class:`ForwardGraph`.

    Supersedes :func:`model_forward_chain` as the fused-program workload:
    sibling projections (k/v/up/router) are emitted as branch outputs of the
    shared layer input instead of skipped, and the non-CiM ops between the
    linears — pre-norms, RoPE-free causal attention mixing, SiLU gating,
    residual adds, the final norm — become explicit nodes. MoE blocks route
    through ONE activated expert (``expert0``) scaled by the router's
    softmax probability; Mamba/hybrid families have no matmul-graph forward
    and raise.

    ``block_only`` emits a single ``block``-prefixed attention+MLP block
    (no final norm / unembed), mirroring ``model_matmuls(block_only=True)``.

    Example::

        >>> from repro_torch.configs.registry import get_config
        >>> from repro_torch.fabric import model_forward_graph
        >>> g = model_forward_graph(get_config("smollm-135m"), 4)
        >>> len(g.matmul_nodes), g.output
        (211, 'unembed')
    """
    if cfg.family not in ("dense", "moe"):
        raise ValueError(
            f"model_forward_graph supports dense|moe families; {cfg.family!r} "
            "has no pure matmul-graph forward (use model_matmuls for costs)"
        )
    d = cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nodes: List[GraphNode] = []

    def norm(name: str, src: str) -> str:
        nodes.append(GraphNode(name, "norm", (src,), d=d, eps=cfg.norm_eps))
        return name

    def mm(name: str, src: str, k: int, n: int, combine: str = "scatter") -> str:
        nodes.append(GraphNode(name, "matmul", (src,), k=k, n=n, combine=combine))
        return name

    def attn_block(p: str, resid: str) -> str:
        ln = norm(f"{p}.ln1", resid)
        q = mm(f"{p}.q_proj", ln, d, h * hd)
        kk = mm(f"{p}.k_proj", ln, d, kv * hd)
        vv = mm(f"{p}.v_proj", ln, d, kv * hd)
        nodes.append(
            GraphNode(f"{p}.attn_mix", "attention", (q, kk, vv),
                      n_heads=h, n_kv_heads=kv, head_dim=hd)
        )
        o = mm(f"{p}.o_proj", f"{p}.attn_mix", h * hd, d)
        nodes.append(GraphNode(f"{p}.attn_res", "residual", (resid, o)))
        return f"{p}.attn_res"

    def swiglu(ln: str, mm_prefix: str, d_ff: int) -> str:
        gate = mm(f"{mm_prefix}.gate_proj", ln, d, d_ff)
        up = mm(f"{mm_prefix}.up_proj", ln, d, d_ff)
        nodes.append(GraphNode(f"{mm_prefix}.silu", "silu_gate", (gate, up)))
        return mm(f"{mm_prefix}.down_proj", f"{mm_prefix}.silu", d_ff, d)

    def dense_mlp(p: str, resid: str) -> str:
        ln = norm(f"{p}.ln2", resid)
        down = swiglu(ln, p, cfg.d_ff or d * 4)
        nodes.append(GraphNode(f"{p}.mlp_res", "residual", (resid, down)))
        return f"{p}.mlp_res"

    def moe_mlp(p: str, resid: str) -> str:
        # ln2 is shared by the router and the activated expert; the router's
        # softmax needs the whole expert axis, so it recombines via psum
        ln = norm(f"{p}.ln2", resid)
        router = mm(f"{p}.router", ln, d, cfg.n_experts, combine="psum")
        down = swiglu(ln, f"{p}.expert0", cfg.d_ff_expert)
        nodes.append(GraphNode(f"{p}.moe_gate", "moe_gate", (down, router)))
        nodes.append(GraphNode(f"{p}.mlp_res", "residual", (resid, f"{p}.moe_gate")))
        return f"{p}.mlp_res"

    resid = "x"
    n_blocks = 1 if block_only else cfg.n_layers
    for i in range(n_blocks):
        p = "block" if block_only else f"layer{i}"
        resid = attn_block(p, resid)
        resid = moe_mlp(p, resid) if cfg.family == "moe" else dense_mlp(p, resid)
    if not block_only:
        resid = norm("ln_f", resid)
        resid = mm("unembed", resid, d, cfg.padded_vocab)
    return ForwardGraph(nodes=tuple(nodes), m=tokens, d_in=d, output=resid)


def model_block_template(
    cfg: ModelConfig, tokens: int
) -> Tuple[ForwardGraph, ForwardGraph]:
    """The block-template form of :func:`model_forward_graph`: ``(block,
    tail)`` where ``block`` is ONE repeated transformer block (the
    ``block.``-prefixed graph of ``block_only=True``, residual stream in,
    residual stream out) and ``tail`` holds the non-repeated nodes after the
    block stack — the final norm and the unembedding, reading the scanned
    carry as their graph input ``"x"``.

    This is the workload ``compile_graph_forward(scan_layers=True)``
    runs: the block's nodes run once per layer over weights stacked on a
    leading layer axis (``graph.stack_block_weights``); in the JAX package
    the block traces once under ``jax.lax.scan``, so its compile cost is
    depth-constant. No node precedes the first block (embeddings enter the
    graph directly as ``"x"``), so the tail is the only out-of-scan part.

    Example::

        >>> from repro_torch.configs.registry import get_config
        >>> from repro_torch.fabric import model_block_template
        >>> block, tail = model_block_template(get_config("smollm-135m"), 4)
        >>> block.output, [nd.name for nd in tail.nodes]
        ('block.mlp_res', ['ln_f', 'unembed'])
    """
    block = model_forward_graph(cfg, tokens, block_only=True)
    d = cfg.d_model
    tail_nodes = (
        GraphNode("ln_f", "norm", ("x",), d=d, eps=cfg.norm_eps),
        GraphNode("unembed", "matmul", ("ln_f",), k=d, n=cfg.padded_vocab),
    )
    tail = ForwardGraph(nodes=tail_nodes, m=tokens, d_in=d, output="unembed")
    return block, tail


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
