"""Full-transformer-block fused forward over the chip mesh (counterpart of
``repro.fabric.graph``).

``fabric.program.compile_forward`` fuses only the residual *chain* (q -> o
-> gate -> down -> unembed): the k/v/up/router siblings and every mixing op
between the linears are dropped. This module runs the COMPLETE block stack
(``mapper.model_forward_graph``) — siblings, attention mixing, SiLU gating,
norms, residual adds — as one program over the chip mesh, the JAX package's
fused ``shard_map`` chip function run for every chip on one torch device:

  * the residual stream stays feature-sharded over the ``model`` axis the
    whole way: every scatter-combined matmul ends in a tiled
    ``psum_scatter`` whose output slice is exactly the consumer's
    tile-aligned K-slice, and ONE trailing ``all_gather`` produces the
    logits;
  * sibling branches (k/v/up) consume the SAME quantized layer input as
    their chained partner — one re-quantization boundary (a ``pmax``) per
    *distinct* matmul input, not per matmul — and pay one extra
    reduce-scatter each, enumerated by ``ForwardGraph.collective_budget``
    and equal to :meth:`GraphProgram.collective_counts`;
  * attention mixing runs chip-local: with ``n_heads % model == 0`` and
    ``n_kv_heads % model == 0`` the k/v scatters hand every chip whole GQA
    head groups, so ``softmax(q kᵀ) v`` (RoPE-free causal) needs NO
    collective;
  * norms are the only ops that read across the sharded feature axis: the
    sum of squares is a per-row ``psum`` over ``model``; the MoE router —
    whose softmax needs the whole expert axis — recombines via ``psum`` and
    gates the ONE activated expert (``expert0``).

Numerics: activation scales divide by a 0-d ``qmax`` tensor and norms by a
0-d ``d`` tensor (``repro_torch.device.divisor``), true IEEE divides on
every device; per-node ADC noise keys are ``fold_in(key, matmul_index)``
then per chip and tile like every other executor; every matmul runs the
shared ``fabric.tiles`` inner loop; the collectives and the per-node loop
both sum the chips' partials in chip order, a norm's sum of squares
included. So the fused graph equals :func:`per_node_forward` (the per-node
``execute_sharded_matmul`` loop with the same mixing helpers) bit for bit
on every mesh, noisy ADC included. Against the JAX package the mixing ops
differ by torch's ``exp`` / ``rsqrt`` / ``sigmoid`` against XLA's (a few
ulp), and its loop sums a norm's row whole, so the logits agree within a
tolerance, not bit for bit.

In ``fake_quant`` every chip's block of every matmul node is one CiM
fake-quant kernel launch (K1) on a CUDA tensor: ``nodes x data x model``
launches a forward.

``compile_graph_forward(scan_layers=True)`` is the scan form: the repeated
block (``mapper.model_block_template``) runs once per layer over weights
stacked on a leading layer axis (:func:`stack_block_weights` /
:func:`unstack_block_weights`), the final norm and unembed after it, with
per-layer noise keys from the global matmul index — equal to the unrolled
program bit for bit. The JAX package traces the block once under
``jax.lax.scan``; torch has nothing to trace, so here the scan is the loop.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.core.cim_linear import CimStats, CiMConfig, quantize_symmetric
from repro_torch.device import divisor, resolve_device
from repro_torch.fabric import collectives as coll
from repro_torch.fabric.mapper import ForwardGraph, model_block_template, model_forward_graph
from repro_torch.fabric.program import _record_request, _record_request_fallback
from repro_torch.fabric.shard import ShardedPlacement, _chip_noise_key, execute_sharded_matmul, shard_model
from repro_torch.fabric.tiles import column_tile_matmul
from repro_torch.fabric.topology import ChipMeshConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.fallback import REASON_RAGGED_BATCH, record_fallback

__all__ = [
    "GraphProgram",
    "compile_graph_forward",
    "per_node_forward",
    "graph_eligibility",
    "shard_forward_graph",
    "transformer_graph_weights",
    "stack_block_weights",
    "unstack_block_weights",
]

_NEG = -1e30


# ---------------------------------------------------------------------------
# Shared non-CiM ops — ONE definition used by the fused program and the
# per-node reference, which is what makes their equality structural
# ---------------------------------------------------------------------------


def _attention_mix(q, k, v, n_heads: int, n_kv_heads: int, head_dim: int):
    """RoPE-free causal GQA mixing ``softmax(q kᵀ / sqrt(hd)) v``.

    ``q``: (B, S, n_heads*hd); ``k``/``v``: (B, S, n_kv_heads*hd). Heads are
    independent, so the fused program calls this on each chip's head slice
    and the reference on all heads — identical per-head arithmetic.
    """
    b, s, _ = q.shape
    g = n_heads // n_kv_heads
    qh = q.reshape(b, s, n_kv_heads, g, head_dim)
    kh = k.reshape(b, s, n_kv_heads, head_dim)
    vh = v.reshape(b, s, n_kv_heads, head_dim)
    scores = torch.einsum("bqkgd,bckd->bqkgc", qh, kh) * (1.0 / math.sqrt(head_dim))
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] <= pos[:, None])[None, :, None, None, :]  # key c visible to query q iff c <= q
    scores = torch.where(mask, scores, torch.full((), _NEG, dtype=scores.dtype, device=q.device))
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m) * mask.to(torch.float32)
    out = torch.einsum("bqkgc,bckd->bqkgd", p, vh)
    out = out / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    return out.reshape(b, s, n_heads * head_dim)


def _sumsq_parts(chunks):
    """Each chip's sum of squares over its feature slice, the slice summed
    alone: the fused program's per-chip partials, which its ``psum`` adds in
    chip order; the per-node loop adds the same parts in the same order, so
    a norm is bit for bit the fused program's on every mesh."""
    return [torch.sum(c * c, dim=-1, keepdim=True) for c in (ch.contiguous() for ch in chunks)]


def _norm_apply(h, scale, eps: float, d_total, sumsq):
    """RMS norm given the (possibly psum-combined) sum of squares over the
    FULL feature axis: ``h * rsqrt(sumsq / d + eps) * (1 + scale)``, the
    form of ``models.layers.rms_norm``. ``d_total`` is a 0-d tensor
    (``device.divisor``), so the divide is a true IEEE divide."""
    inv = torch.rsqrt(sumsq / d_total + eps)
    return h * inv * (1.0 + scale)


def _silu_gate(gate, up):
    return F.silu(gate) * up


def _expert0_prob(router_logits):
    """Softmax probability of the one activated expert (expert0) — the
    graph's MoE semantics: a token's critical path runs through ONE
    expert; the other top_k - 1 run in parallel, not in series."""
    return torch.softmax(router_logits, dim=-1)[..., :1]


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------


def shard_forward_graph(
    cfg: ModelConfig,
    chip_mesh: ChipMeshConfig,
    tokens: int = 1,
    cim: Optional[CiMConfig] = None,
    block_only: bool = False,
) -> Tuple[ForwardGraph, List[ShardedPlacement]]:
    """Build the model's forward graph and shard every matmul node onto the
    mesh — ``shard_model``'s own offset-bookkeeping walk over the graph's
    matmul list, so graph costs and chain costs come from one planner.

    Example::

        >>> from repro_torch.configs.registry import get_config
        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, shard_forward_graph
        >>> cm = ChipMeshConfig(fabric=FabricConfig(mode="hybrid", n_arrays=60))
        >>> g, sps = shard_forward_graph(get_config("smollm-135m"), cm, tokens=4, block_only=True)
        >>> len(sps) == len(g.matmul_nodes)
        True
    """
    graph = model_forward_graph(cfg, tokens, block_only=block_only)
    placements = shard_model(cfg, chip_mesh, tokens=tokens, cim=cim, matmuls=graph.matmuls())
    return graph, placements


def graph_eligibility(
    graph: ForwardGraph,
    placements: Sequence[ShardedPlacement],
    chip_mesh: ChipMeshConfig,
) -> List[str]:
    """Why the fused graph program can('t) run. Empty = eligible.

    The per-matmul conditions of ``program_eligibility`` (no replication
    fallbacks, ``K % (model * rows) == 0``, ``N % model`` for
    scatter-combined nodes), and the mixing invariant: attention heads must
    divide the model axis (``n_heads % model == 0`` and ``n_kv_heads %
    model == 0``) so the k/v scatters hand every chip whole GQA head groups.
    The JAX package also needs ``data * model`` jax devices; the port runs
    every chip on one device and has no such condition.

    Example::

        >>> from repro_torch.configs.registry import get_config
        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, graph_eligibility, shard_forward_graph
        >>> cm = ChipMeshConfig(fabric=FabricConfig(mode="hybrid", n_arrays=60))
        >>> g, sps = shard_forward_graph(get_config("smollm-135m"), cm, tokens=4, block_only=True)
        >>> graph_eligibility(g, sps, cm)
        []
    """
    problems: List[str] = []
    mm_nodes = graph.matmul_nodes
    if not mm_nodes:
        return ["empty graph"]
    fabric = chip_mesh.fabric
    C = chip_mesh.model
    if len(placements) != len(mm_nodes):
        return problems + [
            f"graph has {len(mm_nodes)} matmul nodes but {len(placements)} "
            "placements were supplied"
        ]
    for node, sp in zip(mm_nodes, placements):
        if (sp.name, sp.k, sp.n) != (node.name, node.k, node.n):
            problems.append(
                f"placement {sp.name} (K={sp.k}, N={sp.n}) does not match "
                f"graph node {node.name} (K={node.k}, N={node.n})"
            )
            continue
        if sp.chip_mesh != chip_mesh:
            problems.append(f"{sp.name} was planned on a different mesh")
            continue
        if (sp.d_splits, sp.k_splits) != (chip_mesh.data, chip_mesh.model):
            problems.append(
                f"{sp.name} has replication fallbacks: realized "
                f"{sp.d_splits}x{sp.k_splits} != mesh {chip_mesh.data}x{chip_mesh.model}"
            )
        if sp.k % (C * fabric.rows) != 0:
            problems.append(
                f"{sp.name} K={sp.k} is not a whole number of "
                f"{fabric.rows}-row tiles per model-axis chip"
            )
        if node.combine == "scatter" and sp.n % C != 0:
            problems.append(
                f"{sp.name} N={sp.n} does not divide the model axis ({C}) "
                "for the tiled psum_scatter"
            )
    for node in graph.nodes:
        if node.op == "attention":
            if node.n_heads % C or node.n_kv_heads % C:
                problems.append(
                    f"{node.name}: heads {node.n_heads}/{node.n_kv_heads} (q/kv) "
                    f"do not divide the model axis ({C}); chip-local GQA mixing "
                    "needs whole head groups per chip"
                )
    return problems


# ---------------------------------------------------------------------------
# The fused program
# ---------------------------------------------------------------------------


def _qmax(cim: CiMConfig) -> int:
    return (1 << (cim.a_bits - 1)) - 1 if cim.a_signed else (1 << cim.a_bits) - 1


@dataclasses.dataclass
class GraphProgram:
    """A full-block forward graph over the chip mesh.

    Call it like a function on ``(B, S, d_model)`` embeddings::

        y = program(x, weights, key=key)           # (B, S, N_out)
        y, stats = program(x, weights, return_stats=True)

    ``weights`` is a dict keyed by node name: one float ``(K, N)`` matrix
    per matmul node and one ``(d,)`` scale vector per norm node
    (:meth:`weight_shapes`; :func:`transformer_graph_weights` builds it from
    the port's model params, :meth:`random_weights` from a key).
    ``backend`` is the resolved path: ``"shard_map"`` runs the fused
    program, ``"sequential"`` the per-node reference loop
    (:func:`per_node_forward`) — also the automatic fallback when the
    runtime batch does not divide the data axis.

    Example::

        >>> from repro_torch.configs.base import ModelConfig
        >>> from repro_torch.core import prng
        >>> from repro_torch.core.cim_linear import CiMConfig
        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, compile_graph_forward
        >>> cfg = ModelConfig(name="toy", family="dense", n_layers=1, d_model=64, vocab=64, n_heads=4,
        ...                   n_kv_heads=2, head_dim=16, d_ff=128, pad_vocab_multiple=16)
        >>> cim = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=False)
        >>> prog = compile_graph_forward(cfg, ChipMeshConfig(fabric=FabricConfig(mode="pair_sar", n_arrays=8)),
        ...                              cim, tokens=4)
        >>> x = prng.normal(prng.PRNGKey(0), (1, 4, 64))
        >>> tuple(prog(x, prog.random_weights(prng.PRNGKey(1))).shape)
        (1, 4, 64)
    """

    graph: ForwardGraph
    chip_mesh: ChipMeshConfig
    cim: CiMConfig
    placements: List[ShardedPlacement]  # aligned with graph.matmul_nodes
    backend: str  # resolved: "shard_map" | "sequential"
    requested_backend: str
    problems: List[str]  # why the fused path was ineligible (empty when it runs)
    # the scan form (compile_graph_forward(scan_layers=True)): the repeated
    # block runs once per layer over weights stacked on a leading layer axis;
    # block_graph/tail_graph are the mapper.model_block_template pair and
    # n_blocks the layer count. graph/placements still describe the full
    # unrolled model (budget, reports, reference loop).
    scan_layers: bool = False
    block_graph: Optional[ForwardGraph] = None
    tail_graph: Optional[ForwardGraph] = None
    n_blocks: int = 0

    @property
    def n_layers(self) -> int:
        """Matmul-node count (the unit measure_forward reports)."""
        return len(self.placements)

    @property
    def m(self) -> int:
        return self.graph.m

    @property
    def d_in(self) -> int:
        return self.graph.d_in

    @property
    def n_out(self) -> int:
        out = self.graph.node(self.graph.output)
        return out.n if out.op == "matmul" else self.graph.d_in

    def weight_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Expected shape per weighted node: ``(K, N)`` for matmuls, ``(d,)``
        for norm scales. The scan form keys the repeated block's weights once
        under the ``block.`` prefix with a leading ``n_blocks`` layer axis."""
        shapes: Dict[str, Tuple[int, ...]] = {}
        if self.scan_layers:
            L = self.n_blocks
            for nd in self.block_graph.weighted_nodes():
                shapes[nd.name] = (L, nd.k, nd.n) if nd.op == "matmul" else (L, nd.d)
            for nd in self.tail_graph.weighted_nodes():
                shapes[nd.name] = (nd.k, nd.n) if nd.op == "matmul" else (nd.d,)
            return shapes
        for nd in self.graph.weighted_nodes():
            shapes[nd.name] = (nd.k, nd.n) if nd.op == "matmul" else (nd.d,)
        return shapes

    def random_weights(self, key) -> Dict[str, torch.Tensor]:
        """Standard-normal matmul weights and 0.1-scaled norm scales
        (``fold_in(key, i)`` per weighted node, the JAX program's draws bit
        for bit), on the key's device. The scan form stacks the SAME
        per-layer draws on the leading layer axis."""
        out: Dict[str, torch.Tensor] = {}
        for i, nd in enumerate(self.graph.weighted_nodes()):
            k = prng.fold_in(key, i)
            if nd.op == "matmul":
                out[nd.name] = prng.normal(k, (nd.k, nd.n))
            else:
                out[nd.name] = 0.1 * prng.normal(k, (nd.d,))
        if self.scan_layers:
            return _stack_layer_weights(out, self.n_blocks)
        return out

    def example_input(self, key) -> torch.Tensor:
        """A ``(B, S, d)`` input matching the planned token count ``m``, on
        the key's device — batch set to the data axis when it divides, else
        a single sequence."""
        b = self.chip_mesh.data if self.m % self.chip_mesh.data == 0 else 1
        return prng.normal(key, (b, self.m // b, self.d_in))

    # -- fused program ------------------------------------------------------

    def _fused(self, has_key: bool, collectives: bool = True):
        """Build the fused program: ``fn(x, qmax_f, mask, *flat, count=True)
        -> (y, conversions, comparisons)`` over the arguments of
        :meth:`_prepare` (the key last when ``has_key``).

        ``collectives=False`` builds the timing twin: every collective is
        replaced by a local stand-in of the same shape (numerically wrong by
        construction, same per-chip compute), so ``t(fused) - t(local)``
        isolates the collectives' time for ``measure_forward``.
        """
        cm, cim, graph = self.chip_mesh, self.cim, self.graph
        C, D = cm.model, cm.data
        cols = cm.fabric.cols
        qmax = _qmax(cim)
        lo = -qmax - 1 if cim.a_signed else 0
        scan = self.scan_layers
        if scan:
            block, tail = self.block_graph, self.tail_graph
            block_weighted, tail_weighted = block.weighted_nodes(), tail.weighted_nodes()
            mm_per_block = len(block.matmul_nodes)
        else:
            weighted = graph.weighted_nodes()

        def parse_params(nodes_weighted, args):
            """flat args -> {name: (w_int, sw) | scale}; returns args used."""
            params, i = {}, 0
            for nd in nodes_weighted:
                if nd.op == "matmul":
                    params[nd.name] = (args[i], args[i + 1])
                    i += 2
                else:
                    params[nd.name] = args[i]
                    i += 1
            return params, i

        def fused(x, qmax_f, mask, *flat, count: bool = True):
            # every value is held as (data, model, b_loc, s, its feature slice)
            b, s, d_in = x.shape
            b_loc = b // D
            h0 = x.reshape(D, b_loc, s, C, d_in // C).permute(0, 3, 1, 2, 4)
            if mask is not None:
                # 1.0 on real rows, 0.0 on bucket padding: pad rows stay exactly
                # zero through the stack, so a noisy ADC cannot lift them into
                # the GLOBAL absmax of the next boundary; `y * 1.0` is identity
                mask = mask.reshape(D, 1, b_loc, 1, 1)
            key = flat[-1] if has_key else None
            d_total = {}
            stats = [torch.zeros((D, C), dtype=torch.int32, device=x.device),
                     torch.zeros((D, C), dtype=torch.int32, device=x.device)]

            def run_nodes(nodes, vals, params, mm_idx0):
                """ONE interpreter for a node list — the unrolled program, the
                scan form's block body and its tail all run through it.
                ``mm_idx0`` offsets the per-node noise keys so the scanned
                body reproduces the unrolled ``fold_in(key, matmul_index)``."""
                qcache = {}  # input-node name -> (x_int, scale): one boundary per
                # DISTINCT matmul input, so siblings share their producer's codes
                mm_idx = 0
                for node in nodes:
                    if node.op == "matmul":
                        src = node.inputs[0]
                        if src not in qcache:
                            hv = vals[src]
                            absval = hv.abs() if cim.a_signed else torch.clamp(hv, min=0)
                            absmax = torch.amax(absval, dim=(2, 3, 4))
                            if collectives:
                                # max of shard maxes IS the global max, exactly
                                absmax = coll.pmax(absmax, coll.AXES)
                            scale = torch.where(absmax > 0, absmax / qmax_f, torch.ones_like(absmax))
                            scale = scale[:, :, None, None, None]
                            x_int = torch.clamp(torch.round(hv / scale), lo, qmax)
                            qcache[src] = (x_int.reshape(D, C, b_loc * s, -1), scale.reshape(D, C, 1, 1))
                        x_int, scale = qcache[src]
                        w_int, sw = params[node.name]
                        k_chip = w_int.shape[0] // C
                        nkey = prng.fold_in(key, mm_idx0 + mm_idx) if has_key else None
                        ys, conv, comp = [], [], []
                        for di in range(D):
                            for ci in range(C):
                                # K-shard index only: data chips differ via the
                                # global row ids (row_offset)
                                y_c, st = column_tile_matmul(
                                    x_int[di, ci].contiguous(), w_int[ci * k_chip:(ci + 1) * k_chip], cim, cols,
                                    key=_chip_noise_key(nkey, ci), row_offset=di * b_loc * s, count=count,
                                )
                                ys.append(y_c)
                                if st is not None:
                                    conv.append(st.conversions)
                                    comp.append(st.comparisons)
                        y_int = torch.stack(ys).reshape(D, C, b_loc * s, -1)
                        if conv:
                            stats[0] = stats[0] + torch.stack(conv).reshape(D, C)
                            stats[1] = stats[1] + torch.stack(comp).reshape(D, C)
                        n = y_int.shape[-1]
                        if node.combine == "scatter":
                            nc = n // C
                            if C > 1:
                                if collectives:
                                    # chip ci keeps its tile-aligned K-slice of the consumer
                                    y_int = coll.psum_scatter(y_int, "model", scatter_dimension=1)
                                else:
                                    y_int = torch.stack(
                                        [y_int[:, c, :, c * nc:(c + 1) * nc] for c in range(C)], dim=1
                                    )
                            sw_chip = sw.reshape(C, nc)[None, :, None, :]  # P(None, "model")
                        else:  # psum: the router's full replicated output
                            if collectives:
                                y_int = coll.psum(y_int, "model")
                            sw_chip = sw.reshape(1, 1, 1, n)
                        y = (y_int * scale * sw_chip).reshape(D, C, b_loc, s, -1)
                        vals[node.name] = y if mask is None else y * mask
                        mm_idx += 1
                    elif node.op == "norm":
                        hv = vals[node.inputs[0]]
                        sumsq = torch.stack(_sumsq_parts(hv.unbind(1)), dim=1)
                        if collectives:
                            sumsq = coll.psum(sumsq, "model")
                        if node.d not in d_total:
                            d_total[node.d] = divisor(node.d, hv, hv.dtype)
                        scale = params[node.name].reshape(C, -1)[None, :, None, None, :]  # P("model")
                        vals[node.name] = _norm_apply(hv, scale, node.eps, d_total[node.d], sumsq)
                    elif node.op == "attention":
                        q, k_, v_ = (vals[nm].reshape(D * C * b_loc, s, -1) for nm in node.inputs)
                        mixed = _attention_mix(q, k_, v_, node.n_heads // C, node.n_kv_heads // C, node.head_dim)
                        vals[node.name] = mixed.reshape(D, C, b_loc, s, -1)
                    elif node.op == "silu_gate":
                        vals[node.name] = _silu_gate(*(vals[nm] for nm in node.inputs))
                    elif node.op == "residual":
                        a, b_ = (vals[nm] for nm in node.inputs)
                        vals[node.name] = a + b_
                    elif node.op == "moe_gate":
                        expert, router = (vals[nm] for nm in node.inputs)
                        vals[node.name] = expert * _expert0_prob(router)
                    else:  # pragma: no cover — the taxonomy is closed in the mapper
                        raise ValueError(f"unknown graph op {node.op!r}")
                return vals

            if scan:
                stacked, used = parse_params(block_weighted, flat)
                tail_params, _ = parse_params(tail_weighted, flat[used:])
                h = h0
                for li in range(self.n_blocks):
                    params_l = {name: tuple(t[li] for t in p) if isinstance(p, tuple) else p[li]
                                for name, p in stacked.items()}
                    # the carry stays the feature-sharded residual stream
                    h = run_nodes(block.nodes, {"x": h}, params_l, li * mm_per_block)[block.output]
                out = run_nodes(tail.nodes, {"x": h}, tail_params, self.n_blocks * mm_per_block)[tail.output]
            else:
                params, _ = parse_params(weighted, flat)
                out = run_nodes(graph.nodes, {"x": h0}, params, 0)[graph.output]
            if C > 1:
                if collectives:
                    out = coll.all_gather(out, "model", gather_dimension=2)  # the ONE gather
                else:
                    out = torch.cat([out] * C, dim=4)
            conversions, comparisons = stats
            if collectives:
                conversions = coll.psum(conversions, coll.AXES)
                comparisons = coll.psum(comparisons, coll.AXES)
            # P("data", None, None): the rows of chip (d, 0), in data order
            return out[:, 0].reshape(b, s, -1), conversions[0, 0], comparisons[0, 0]

        return fused

    def _prepare(self, x, weights, key, real_rows=None):
        """Validate shapes, quantize matmul weights (exactly the reference
        loop's front-end, per call), and assemble the fused argument list
        ``[qmax_f, mask, *weights, key]``.

        ``real_rows`` marks the first ``real_rows`` batch rows as real and the
        rest as bucket padding (``fabric.autotune``): the pad-row mask zeroes
        padded rows at every matmul node so they cannot perturb the global
        quantization scales real rows see."""
        shapes = self.weight_shapes()
        missing = sorted(set(shapes) - set(weights))
        if missing:
            raise ValueError(f"missing graph weights: {missing}")
        if x.dim() != 3:
            raise ValueError(f"graph forward wants (batch, seq, d) embeddings; got {tuple(x.shape)}")
        if x.shape[-1] != self.d_in:
            raise ValueError(f"input features {x.shape[-1]} != graph d={self.d_in}")
        for name, shape in shapes.items():
            if tuple(weights[name].shape) != shape:
                raise ValueError(f"node {name} expects weights {shape}, got {tuple(weights[name].shape)}")
        if real_rows is None:
            mask = None
        else:
            if not 1 <= real_rows <= x.shape[0]:
                raise ValueError(f"real_rows={real_rows} outside [1, batch={x.shape[0]}]")
            mask = (torch.arange(x.shape[0], device=x.device) < real_rows).to(torch.float32)
        # a 0-d device tensor: dividing by it is a true IEEE divide on every
        # device (the JAX program passes its qmax traced for the same reason)
        flat = [divisor(_qmax(self.cim), x, torch.float32), mask]
        f32 = lambda w: torch.as_tensor(w, dtype=torch.float32, device=x.device)  # noqa: E731

        def quantized(w):
            return quantize_symmetric(f32(w), self.cim.w_bits, self.cim.w_signed, per_axis=-1)

        if self.scan_layers:
            for nd in self.block_graph.weighted_nodes():
                w = weights[nd.name]
                if nd.op == "matmul":
                    # per layer, the same quantize_symmetric call the unrolled
                    # program makes on layer{i}'s weight
                    per = [quantized(w[i]) for i in range(self.n_blocks)]
                    flat += [torch.stack([p[0] for p in per]), torch.stack([p[1] for p in per])]
                else:
                    flat.append(f32(w))
            spec_nodes = self.tail_graph.weighted_nodes()
        else:
            spec_nodes = self.graph.weighted_nodes()
        for nd in spec_nodes:
            if nd.op == "matmul":
                flat += list(quantized(weights[nd.name]))
            else:
                flat.append(f32(weights[nd.name]))
        if key is not None:
            flat.append(prng.as_key(key, x.device))
        return flat

    def _unrolled_weights(self, weights):
        """The per-layer weight dict the reference loop wants — stacked
        ``block.`` weights unstacked back to ``layer{i}.`` keys in the scan
        form, passthrough otherwise."""
        if self.scan_layers:
            return unstack_block_weights(weights, self.n_blocks)
        return weights

    def _fused_args(self, x, weights, key, real_rows=None):
        """The fused callable's argument tuple (``measure_forward``)."""
        return (x, *self._prepare(x, weights, key, real_rows=real_rows))

    def fused_available(self, x) -> bool:
        """Whether the fused path can run THIS input — the resolved backend
        plus ``__call__``'s ragged-batch condition (batch divisible by the
        data axis)."""
        if self.backend != "shard_map" or x.dim() != 3:
            return False
        return x.shape[0] % self.chip_mesh.data == 0

    def __call__(self, x, weights, key=None, return_stats: bool = False, real_rows: Optional[int] = None):
        """Run the program. ``real_rows`` (``fabric.autotune``'s bucketed
        batches) declares that only the first ``real_rows`` batch rows are
        real and the rest zero padding up to a bucket boundary: the fused
        program masks pad rows out of every matmul node, the returned logits
        are sliced back to ``real_rows``, and stats/metrics account only the
        real rows — so a padded run equals, and reports like, the unpadded
        reference."""
        b = x.shape[0]
        if real_rows is not None and not 1 <= real_rows <= b:
            raise ValueError(f"real_rows={real_rows} outside [1, batch={b}]")
        if self.backend != "shard_map" or b % self.chip_mesh.data:
            if self.backend == "shard_map":
                # the fused program exists but THIS batch is ragged
                if self.requested_backend == "shard_map":
                    raise ValueError(
                        f"fused graph program unavailable: batch {b} is "
                        f"not divisible by the data axis ({self.chip_mesh.data})"
                    )
                record_fallback(
                    "fabric.graph", REASON_RAGGED_BATCH,
                    f"batch {b} % data axis {self.chip_mesh.data} != 0",
                )
            else:
                _record_request_fallback("fabric.graph", self)
            _record_request("fabric.graph", self, 0, fused=False)
            # pad rows are pure bucket filler — the reference loop only sees
            # the real rows (per-row noise keys make that equivalent)
            x_ref = x if real_rows is None else x[:real_rows]
            return per_node_forward(
                x_ref, self._unrolled_weights(weights), self.graph, self.placements, self.chip_mesh, self.cim,
                key=key, backend="sequential", return_stats=return_stats,
            )
        flat = self._prepare(x, weights, key, real_rows=real_rows)
        rows = b if real_rows is None else real_rows
        _record_request("fabric.graph", self, rows * x.shape[1], fused=True)
        with obs_trace.span(
            "fabric.graph.forward", n_matmuls=self.n_layers,
            mesh=f"{self.chip_mesh.data}x{self.chip_mesh.model}", tokens=rows * x.shape[1],
        ):
            y, conversions, comparisons = self._fused(key is not None)(x, *flat, count=return_stats)
        if real_rows is not None:
            y = y[:real_rows]
            # conversions are per-row-constant, so the real_rows/b rescaling is
            # exact; comparator counts are data-dependent, so the pad-row share
            # is removed proportionally (pad rows digitize all-zero mavs)
            conversions = conversions * real_rows // b
            comparisons = comparisons * real_rows // b
        if return_stats:
            return y, CimStats(conversions, comparisons)
        return y

    def reference_forward(self, x, weights, key=None, backend: str = "sequential", return_stats: bool = False):
        """The per-node reference loop on this program's placements — what
        ``measure_forward`` times as the unfused baseline. Takes this
        program's own weight dict, stacked or not."""
        return per_node_forward(
            x, self._unrolled_weights(weights), self.graph, self.placements, self.chip_mesh, self.cim,
            key=key, backend=backend, return_stats=return_stats,
        )

    # -- introspection ------------------------------------------------------

    def collective_counts(self, x=None, weights=None, key=None, device="cuda") -> dict:
        """The collectives of one fused forward, by the JAX primitive's name
        (``fabric.collectives.census``) — equal to
        ``graph.collective_budget(model)``: per-sibling scatters, ONE
        trailing all-gather, one pmax per re-quantization boundary, one psum
        per norm and router plus the two stats totals. The scan form counts
        the same: per-block census x ``n_blocks`` plus the tail. Runs the
        forward once, on ``x`` and ``weights`` (zeros on ``device`` by
        default)."""
        if self.backend != "shard_map":
            raise ValueError("collective_counts needs the shard_map backend")
        if x is None:
            b = self.chip_mesh.data
            x = torch.zeros((b, max(1, self.m // b), self.d_in), device=resolve_device(device))
        if weights is None:
            weights = {name: torch.zeros(shape, device=x.device) for name, shape in self.weight_shapes().items()}
        flat = self._prepare(x, weights, key)
        with coll.census() as counts:
            self._fused(key is not None)(x, *flat, count=False)
        return counts

    def collective_budget(self) -> dict:
        """The documented budget (``ForwardGraph.collective_budget``) for
        this program's mesh."""
        return self.graph.collective_budget(self.chip_mesh.model)


def compile_graph_forward(
    model: Union[ModelConfig, ForwardGraph],
    chip_mesh: ChipMeshConfig,
    cim: Optional[CiMConfig] = None,
    backend: str = "auto",
    tokens: int = 1,
    block_only: bool = False,
    placements: Optional[Sequence[ShardedPlacement]] = None,
    scan_layers: bool = False,
) -> GraphProgram:
    """Plan a complete transformer-block stack as one fused forward over the
    chip mesh.

    ``model`` is a :class:`~repro_torch.configs.base.ModelConfig` (its
    forward graph — ``mapper.model_forward_graph`` — is built and sharded
    with the usual round-robin offsets) or an explicit :class:`ForwardGraph`
    (with optional pre-sharded ``placements``). ``backend`` mirrors
    ``compile_forward``: ``"shard_map"`` raises with the reasons when the
    fused program is ineligible (:func:`graph_eligibility`), ``"auto"``
    falls back to the per-node loop — and fuses even on a 1x1 mesh.

    ``scan_layers=True`` runs the repeated transformer block once per layer
    over weights stacked on a leading layer axis (``stack_block_weights``
    builds that dict from the model's params; :meth:`GraphProgram.random_weights`
    stacks its own draws), equal to the unrolled program bit for bit. It
    needs a ``ModelConfig`` and the full model (``block_only=False``).

    Example::

        >>> from repro_torch.configs.registry import get_config
        >>> from repro_torch.core.cim_linear import CiMConfig
        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, compile_graph_forward
        >>> cm = ChipMeshConfig(model=3, fabric=FabricConfig(mode="hybrid", n_arrays=256))
        >>> prog = compile_graph_forward(get_config("smollm-135m"), cm, CiMConfig(mode="fake_quant", ste=False),
        ...                              tokens=4)
        >>> prog.backend, prog.n_layers
        ('shard_map', 211)
    """
    if backend not in ("auto", "sequential", "shard_map"):
        raise ValueError(f"unknown backend {backend!r}")
    if scan_layers:
        if not isinstance(model, ModelConfig):
            raise ValueError(
                "scan_layers needs a ModelConfig: the repeated-block template "
                "comes from mapper.model_block_template, not an ad-hoc graph"
            )
        if block_only:
            raise ValueError(
                "scan_layers compiles the FULL model (the scan runs the "
                "block n_layers times); drop block_only"
            )
    if cim is None:
        cim = CiMConfig(mode="bitplane", adc_bits=chip_mesh.fabric.adc_bits, rows=chip_mesh.fabric.rows, ste=False)
    if cim.mode not in ("bitplane", "fake_quant"):
        raise ValueError(f"fabric execution needs bitplane|fake_quant, got {cim.mode!r}")
    if cim.ste:
        raise ValueError(
            "the fused graph feeds node outputs straight into the next "
            "CiM boundary's quantizer; pass a cim with ste=False"
        )
    if isinstance(model, ModelConfig):
        graph, placements = shard_forward_graph(model, chip_mesh, tokens=tokens, cim=cim, block_only=block_only)
    else:
        graph = model
        if placements is None:
            placements = shard_model(None, chip_mesh, tokens=graph.m, cim=cim, matmuls=graph.matmuls())
        else:
            placements = list(placements)
    problems = graph_eligibility(graph, placements, chip_mesh)
    if backend == "sequential":
        resolved = "sequential"
    elif problems:
        if backend == "shard_map":
            raise ValueError("fused graph program unavailable: " + "; ".join(problems))
        obs_trace.event("fabric.graph.ineligible", problems=list(problems))
        resolved = "sequential"
    else:
        resolved = "shard_map"
    block_graph = tail_graph = None
    n_blocks = 0
    if scan_layers:
        block_graph, tail_graph = model_block_template(model, tokens)
        n_blocks = model.n_layers
    return GraphProgram(
        graph=graph,
        chip_mesh=chip_mesh,
        cim=cim,
        placements=list(placements),
        backend=resolved,
        requested_backend=backend,
        problems=problems,
        scan_layers=scan_layers,
        block_graph=block_graph,
        tail_graph=tail_graph,
        n_blocks=n_blocks,
    )


def per_node_forward(
    x,
    weights: Dict[str, torch.Tensor],
    graph: ForwardGraph,
    placements: Sequence[ShardedPlacement],
    chip_mesh: ChipMeshConfig,
    cim: CiMConfig,
    key=None,
    backend: str = "sequential",
    return_stats: bool = False,
    key_fn=None,
):
    """The reference forward: one ``execute_sharded_matmul`` per matmul node
    plus the SAME mixing helpers as the fused program, with the program's
    per-node noise keys (``fold_in(key, matmul_index)``) — the loop the
    fused graph equals on every mesh, and the fallback for ragged batches.

    A norm's sum of squares is summed per model-axis chip slice and the
    parts added in chip order, as the fused program's ``psum`` adds them, so
    the two are equal on every mesh; the JAX package's loop sums the whole
    row (on a ``model = 1`` mesh the same thing).

    ``key_fn(key, matmul_index) -> node_key`` overrides the default
    derivation (the noise-key-independence tests use it).

    Example::

        >>> from repro_torch.configs.base import ModelConfig
        >>> from repro_torch.core import prng
        >>> from repro_torch.core.cim_linear import CiMConfig
        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, compile_graph_forward, per_node_forward
        >>> cfg = ModelConfig(name="toy", family="dense", n_layers=1, d_model=64, vocab=64, n_heads=4,
        ...                   n_kv_heads=2, head_dim=16, d_ff=128, pad_vocab_multiple=16)
        >>> cim = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=False)
        >>> prog = compile_graph_forward(cfg, ChipMeshConfig(fabric=FabricConfig(mode="pair_sar", n_arrays=8)),
        ...                              cim, tokens=4)
        >>> x = prng.normal(prng.PRNGKey(0), (1, 4, 64))
        >>> ws = prog.random_weights(prng.PRNGKey(1))
        >>> tuple(per_node_forward(x, ws, prog.graph, prog.placements, prog.chip_mesh, cim).shape)
        (1, 4, 64)
    """
    if x.dim() != 3:
        raise ValueError(f"graph forward wants (batch, seq, d) embeddings; got {tuple(x.shape)}")
    sp_by_name = {sp.name: sp for sp in placements}
    chips = chip_mesh.model
    b, s = x.shape[0], x.shape[1]
    conversions = torch.zeros((), dtype=torch.int32, device=x.device)
    comparisons = torch.zeros((), dtype=torch.int32, device=x.device)
    f32 = lambda w: torch.as_tensor(w, dtype=torch.float32, device=x.device)  # noqa: E731
    vals = {"x": x}
    mm_idx = 0
    for node in graph.nodes:
        if node.op == "matmul":
            h = vals[node.inputs[0]]
            if key is None:
                nkey = None
            elif key_fn is not None:
                nkey = key_fn(key, mm_idx)
            else:
                nkey = prng.fold_in(key, mm_idx)
            out = execute_sharded_matmul(
                h.reshape(-1, h.shape[-1]), f32(weights[node.name]), chip_mesh, cim,
                sharded=sp_by_name[node.name], key=nkey, return_stats=return_stats, backend=backend,
            )
            if return_stats:
                out, st = out
                conversions = conversions + st.conversions
                comparisons = comparisons + st.comparisons
            vals[node.name] = out.reshape(b, s, -1)
            mm_idx += 1
        elif node.op == "norm":
            h = vals[node.inputs[0]]
            parts = _sumsq_parts(h.chunk(chips, dim=-1) if h.shape[-1] % chips == 0 else [h])
            sumsq = parts[0]
            for part in parts[1:]:  # chip order, as the fused program's psum
                sumsq = sumsq + part
            vals[node.name] = _norm_apply(h, f32(weights[node.name]), node.eps, divisor(node.d, h, h.dtype), sumsq)
        elif node.op == "attention":
            q, k_, v_ = (vals[nm] for nm in node.inputs)
            vals[node.name] = _attention_mix(q, k_, v_, node.n_heads, node.n_kv_heads, node.head_dim)
        elif node.op == "silu_gate":
            vals[node.name] = _silu_gate(*(vals[nm] for nm in node.inputs))
        elif node.op == "residual":
            a, b_ = (vals[nm] for nm in node.inputs)
            vals[node.name] = a + b_
        elif node.op == "moe_gate":
            expert, router = (vals[nm] for nm in node.inputs)
            vals[node.name] = expert * _expert0_prob(router)
        else:  # pragma: no cover
            raise ValueError(f"unknown graph op {node.op!r}")
    out = vals[graph.output]
    if return_stats:
        return out, CimStats(conversions, comparisons)
    return out


# ---------------------------------------------------------------------------
# Weight adapters
# ---------------------------------------------------------------------------


def _check_graph_family(cfg: ModelConfig) -> None:
    if cfg.qkv_bias:
        raise ValueError("the fabric graph maps pure matmuls; qkv_bias is unsupported")
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"no transformer graph for family {cfg.family!r}")


def _f32(a) -> torch.Tensor:
    return a.to(torch.float32)


def transformer_graph_weights(params: dict, cfg: ModelConfig, block_only: bool = False) -> Dict[str, torch.Tensor]:
    """Adapt the port's transformer parameters (``models.weights.params_from_jax``
    or the model's ``init``) into a graph weight dict.

    Matmul weights are cast to float32 (the fabric quantizes them itself,
    per column); norm scales map ``ln1``/``ln2``/``ln_f`` directly. MoE maps
    the router plus the ONE activated expert's (expert0) SwiGLU weights.
    ``block_only`` uses layer 0 under the ``block`` prefix. QKV biases are
    not representable on the fabric and raise.

    Example::

        >>> import torch
        >>> from repro_torch.configs.base import ModelConfig
        >>> from repro_torch.fabric import transformer_graph_weights
        >>> from repro_torch.models import build_model
        >>> cfg = ModelConfig(name="toy", family="dense", n_layers=2, d_model=64, vocab=64, n_heads=4,
        ...                   n_kv_heads=2, head_dim=16, d_ff=128, pad_vocab_multiple=16, param_dtype="float32")
        >>> params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        >>> ws = transformer_graph_weights(params, cfg)
        >>> tuple(ws["layer0.q_proj"].shape), tuple(ws["ln_f"].shape), tuple(ws["unembed"].shape)
        ((64, 64), (64,), (64, 64))
    """
    _check_graph_family(cfg)
    out: Dict[str, torch.Tensor] = {}
    attn = params["attn"]
    for i in range(1 if block_only else cfg.n_layers):
        p = "block" if block_only else f"layer{i}"
        out[f"{p}.ln1"] = _f32(params["ln1"][i])
        out[f"{p}.q_proj"] = _f32(attn["wq"][i])
        out[f"{p}.k_proj"] = _f32(attn["wk"][i])
        out[f"{p}.v_proj"] = _f32(attn["wv"][i])
        out[f"{p}.o_proj"] = _f32(attn["wo"][i])
        out[f"{p}.ln2"] = _f32(params["ln2"][i])
        if cfg.n_experts:
            moe = params["moe"]
            out[f"{p}.router"] = _f32(moe["router"][i])
            out[f"{p}.expert0.gate_proj"] = _f32(moe["w_gate"][i, 0])
            out[f"{p}.expert0.up_proj"] = _f32(moe["w_up"][i, 0])
            out[f"{p}.expert0.down_proj"] = _f32(moe["w_down"][i, 0])
        else:
            mlp = params["mlp"]
            out[f"{p}.gate_proj"] = _f32(mlp["w_gate"][i])
            out[f"{p}.up_proj"] = _f32(mlp["w_up"][i])
            out[f"{p}.down_proj"] = _f32(mlp["w_down"][i])
    if not block_only:
        from repro_torch.models.layers import unembed_weight

        out["ln_f"] = _f32(params["ln_f"])
        out["unembed"] = _f32(unembed_weight(params["embed"], cfg))
    return out


def stack_block_weights(params: dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Adapt the port's transformer parameters into the SCANNED graph weight
    dict: the repeated block's weights keyed once under the ``block.``
    prefix with their native leading ``(n_layers, ...)`` axis (the params
    already stack every per-layer parameter), plus the tail (``ln_f``,
    ``unembed``). Slicing layer ``i`` off a stacked entry gives
    :func:`transformer_graph_weights`'s ``layer{i}.*`` entry exactly.

    Example::

        >>> import torch
        >>> from repro_torch.configs.base import ModelConfig
        >>> from repro_torch.fabric import stack_block_weights
        >>> from repro_torch.models import build_model
        >>> cfg = ModelConfig(name="toy", family="dense", n_layers=2, d_model=64, vocab=64, n_heads=4,
        ...                   n_kv_heads=2, head_dim=16, d_ff=128, pad_vocab_multiple=16, param_dtype="float32")
        >>> ws = stack_block_weights(build_model(cfg, "cpu").init(torch.Generator().manual_seed(0)), cfg)
        >>> tuple(ws["block.q_proj"].shape), tuple(ws["block.ln1"].shape), tuple(ws["unembed"].shape)
        ((2, 64, 64), (2, 64), (64, 64))
    """
    _check_graph_family(cfg)
    from repro_torch.models.layers import unembed_weight

    attn = params["attn"]
    out: Dict[str, torch.Tensor] = {
        "block.ln1": _f32(params["ln1"]),
        "block.q_proj": _f32(attn["wq"]),
        "block.k_proj": _f32(attn["wk"]),
        "block.v_proj": _f32(attn["wv"]),
        "block.o_proj": _f32(attn["wo"]),
        "block.ln2": _f32(params["ln2"]),
    }
    if cfg.n_experts:
        moe = params["moe"]
        out["block.router"] = _f32(moe["router"])
        out["block.expert0.gate_proj"] = _f32(moe["w_gate"][:, 0])
        out["block.expert0.up_proj"] = _f32(moe["w_up"][:, 0])
        out["block.expert0.down_proj"] = _f32(moe["w_down"][:, 0])
    else:
        mlp = params["mlp"]
        out["block.gate_proj"] = _f32(mlp["w_gate"])
        out["block.up_proj"] = _f32(mlp["w_up"])
        out["block.down_proj"] = _f32(mlp["w_down"])
    out["ln_f"] = _f32(params["ln_f"])
    out["unembed"] = _f32(unembed_weight(params["embed"], cfg))
    return out


def unstack_block_weights(weights: Dict[str, torch.Tensor], n_layers: int) -> Dict[str, torch.Tensor]:
    """The inverse adapter: a scanned (``block.``-stacked) weight dict back
    to the unrolled ``layer{i}.*`` form — each layer a view of the stacked
    tensor, so the per-node reference loop sees exactly the weights the scan
    form slices at layer ``i``.

    Example::

        >>> import torch
        >>> from repro_torch.fabric import unstack_block_weights
        >>> sorted(unstack_block_weights({"block.ln1": torch.zeros(2, 4), "ln_f": torch.ones(4)}, 2))
        ['layer0.ln1', 'layer1.ln1', 'ln_f']
    """
    out: Dict[str, torch.Tensor] = {}
    for name, w in weights.items():
        if name.startswith("block."):
            suffix = name[len("block."):]
            for i in range(n_layers):
                out[f"layer{i}.{suffix}"] = w[i]
        else:
            out[name] = w
    return out


def _stack_layer_weights(weights: Dict[str, torch.Tensor], n_layers: int) -> Dict[str, torch.Tensor]:
    """Stack an unrolled ``layer{i}.*`` weight dict onto the leading layer
    axis under the ``block.`` prefix (random_weights' scan form)."""
    out: Dict[str, torch.Tensor] = {}
    done = set()
    for name in weights:
        if name.startswith("layer") and "." in name:
            suffix = name.split(".", 1)[1]
            if suffix in done:
                continue
            done.add(suffix)
            out[f"block.{suffix}"] = torch.stack([weights[f"layer{i}.{suffix}"] for i in range(n_layers)])
        else:
            out[name] = weights[name]
    return out
