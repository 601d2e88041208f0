"""Continuous batching for the fused graph program: a bucketed program
cache and cost-model-driven mesh/bucket autotuning (counterpart of
``repro.fabric.autotune``).

The fused :class:`~repro_torch.fabric.graph.GraphProgram` needs the runtime
batch to divide the mesh's data axis; a ragged request batch would leave it
for the per-node loop. This module removes that cliff:

  * :class:`BucketedGraphCache` — a small LRU of ``GraphProgram`` objects keyed
    by ``(padded batch, mesh, scan_layers, noisy)``. A ragged batch is
    zero-padded up to the nearest bucket boundary and served on the fused
    path with ``real_rows`` set: pad rows are masked out of every matmul
    node (they cannot perturb the global quantization scales), the logits
    are sliced back, and stats / metrics / link bits account only the real
    rows — so the padded run reports exactly like the unpadded reference,
    and equals it bit for bit wherever the fused program equals its
    per-node loop (every ``model = 1`` mesh). Requests that fit a bucket
    count a ``fabric_bucket_hits_total`` (NOT a ``ragged_batch``
    fallback); only a batch larger than every bucket falls back, with the
    ``no_bucket`` reason and a ``fabric_bucket_misses_total`` increment.
  * :func:`autotune_plan` — given a request-mix histogram
    (:func:`request_histogram`), search ``(data x model)`` mesh shapes and
    bucket boundary sets against the graph cost model
    (``overlapped_mesh_latency`` over ``shard_forward_graph`` placements,
    whose link term is the ``(C-1) * M * N * psum_bits`` reduce-scatter
    budget) under ``graph_eligibility``'s constraints (``K % (model *
    rows)``, GQA head groups ``n_heads % model == 0``), and return the
    cheapest feasible :class:`AutotunePlan`. The default mesh with a single
    max-batch bucket is always in the search space, so the plan's cost never
    exceeds the default's. The JAX package also rejects a mesh with more
    chips than host devices; the port runs every chip on one device and has
    no such condition.

Padding rests on two properties built into the executors:

  1. **Per-row noise keys** — comparator draws derive from the GLOBAL row
     id (``fold_in(cmp_key, row_offset + i)`` inside
     ``core.cim_linear._bitplane_matmul``), so a row's draws are invariant
     to the batch size and the data split: pad rows never consume another
     row's noise.
  2. **Pad-row masking** — the fused program multiplies a {0, 1} row mask
     into every matmul node output. A noisy ADC lifts a zero input row off
     zero, which would otherwise leak into the global activation absmax at
     the next re-quantization boundary; the mask is a bitwise no-op on real
     rows.

Surfaced as ``serve --fabric-autotune``.
"""

from __future__ import annotations

import dataclasses
from collections import Counter, OrderedDict
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cim_linear import CiMConfig
from repro_torch.fabric.graph import (
    GraphProgram,
    compile_graph_forward,
    graph_eligibility,
    shard_forward_graph,
)
from repro_torch.fabric.pipeline import overlapped_mesh_latency
from repro_torch.fabric.topology import ChipMeshConfig, FabricConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.fallback import REASON_NO_BUCKET, record_fallback

__all__ = [
    "BucketedGraphCache",
    "AutotunePlan",
    "autotune_plan",
    "autotune_section",
    "request_histogram",
]


def request_histogram(batches: Iterable[int]) -> Dict[int, int]:
    """Collapse a request-batch trace into the ``{batch_size: count}``
    histogram :func:`autotune_plan` consumes.

    Example::

        >>> request_histogram([3, 1, 3, 4])
        {1: 1, 3: 2, 4: 1}
    """
    hist = Counter()
    for b in batches:
        b = int(b)
        if b < 1:
            raise ValueError(f"request batch sizes must be >= 1, got {b}")
        hist[b] += 1
    return dict(sorted(hist.items()))


def _validate_buckets(buckets: Sequence[int], data: int) -> Tuple[int, ...]:
    out = tuple(sorted(set(int(b) for b in buckets)))
    if not out:
        raise ValueError("need at least one bucket boundary")
    for b in out:
        if b < 1 or b % data:
            raise ValueError(
                f"bucket boundary {b} must be a positive multiple of the "
                f"data axis ({data})"
            )
    return out


class BucketedGraphCache:
    """LRU cache of fused graph programs over batch buckets.

    ``buckets`` are padded-batch boundaries (each a multiple of the mesh's
    data axis, ascending). A request batch ``B`` is served by the smallest
    bucket ``>= B``: the input is zero-padded to the bucket, run through the
    bucket's fused ``GraphProgram`` with ``real_rows=B``, and sliced back —
    equal to the unpadded per-node reference on every ``model = 1`` mesh,
    noisy ADC included. At most ``capacity`` programs stay resident; the
    least recently used is evicted (in the JAX package, with its compiled
    executable; a port program is its plan, rebuilt on next use).

    Counters (``repro_torch.obs``, when collecting):
      * ``fabric_bucket_hits_total`` — requests that fit a bucket (served
        fused; a RAGGED batch landing in a bucket is a hit, not a
        ``ragged_batch`` fallback),
      * ``fabric_bucket_misses_total`` — requests larger than every bucket
        (fall back to the per-node loop with the ``no_bucket`` reason),
      * ``fabric_pad_waste_rows_total`` — pad rows added by bucket rounding.

    Example::

        >>> from repro_torch.configs.base import ModelConfig
        >>> from repro_torch.core import prng
        >>> from repro_torch.core.cim_linear import CiMConfig
        >>> from repro_torch.fabric import BucketedGraphCache, ChipMeshConfig, FabricConfig
        >>> cfg = ModelConfig(name="toy", family="dense", n_layers=1, d_model=64, vocab=64, n_heads=4,
        ...                   n_kv_heads=2, head_dim=16, d_ff=128, pad_vocab_multiple=16)
        >>> cm = ChipMeshConfig(data=2, fabric=FabricConfig(mode="pair_sar", n_arrays=8))
        >>> cim = CiMConfig(mode="fake_quant", ste=False)
        >>> cache = BucketedGraphCache(cfg, cm, cim, buckets=(4, 8), seq=2)
        >>> ws = cache.program_for(4).random_weights(prng.PRNGKey(1))
        >>> tuple(cache(prng.normal(prng.PRNGKey(0), (3, 2, 64)), ws).shape)  # padded to 4, sliced to 3
        (3, 2, 64)
    """

    def __init__(
        self,
        cfg: ModelConfig,
        chip_mesh: ChipMeshConfig,
        cim: CiMConfig,
        buckets: Sequence[int],
        seq: int = 1,
        capacity: int = 4,
        scan_layers: bool = False,
        block_only: bool = False,
        backend: str = "auto",
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.cfg = cfg
        self.chip_mesh = chip_mesh
        self.cim = cim
        self.buckets = _validate_buckets(buckets, chip_mesh.data)
        self.seq = seq
        self.capacity = capacity
        self.scan_layers = scan_layers
        self.block_only = block_only
        self.backend = backend
        self._programs: "OrderedDict[tuple, GraphProgram]" = OrderedDict()
        # host-side mirrors of the obs counters, live even with metrics off
        self.hits = 0
        self.misses = 0
        self.pad_waste_rows = 0
        self.compiles = 0
        self.evictions = 0

    def bucket_for(self, batch: int) -> Optional[int]:
        """Smallest bucket boundary ``>= batch`` (None when none fits)."""
        for b in self.buckets:
            if b >= batch:
                return b
        return None

    def _key(self, padded_batch: int, noisy: bool) -> tuple:
        return (
            padded_batch,
            (self.chip_mesh.data, self.chip_mesh.model),
            self.scan_layers,
            noisy,
        )

    def program_for(self, padded_batch: int, noisy: bool = False) -> GraphProgram:
        """The compiled program serving bucket ``padded_batch`` — LRU get,
        compiling (and evicting the least recently used entry past
        ``capacity``) on first touch."""
        key = self._key(padded_batch, noisy)
        prog = self._programs.get(key)
        if prog is not None:
            self._programs.move_to_end(key)
            return prog
        prog = compile_graph_forward(
            self.cfg, self.chip_mesh, cim=self.cim, backend=self.backend,
            tokens=padded_batch * self.seq, block_only=self.block_only,
            scan_layers=self.scan_layers,
        )
        self.compiles += 1
        self._programs[key] = prog
        while len(self._programs) > self.capacity:
            self._programs.popitem(last=False)
            self.evictions += 1
        return prog

    def __call__(self, x, weights, key=None, return_stats: bool = False):
        """Serve one request batch ``x`` of shape ``(B, S, d)``.

        Fits a bucket: zero-pad to the boundary, run fused with
        ``real_rows=B``, slice back — results and stats are exactly the
        unpadded reference's. No bucket fits: ``no_bucket`` fallback to the
        per-node loop on the raw batch.
        """
        b = x.shape[0]
        pb = self.bucket_for(b)
        if pb is None:
            self.misses += 1
            record_fallback(
                "fabric.autotune", REASON_NO_BUCKET,
                f"batch {b} exceeds largest bucket {self.buckets[-1]}",
            )
            if obs_metrics.active():
                obs_metrics.inc(
                    "fabric_bucket_misses_total",
                    help="Requests larger than every configured batch bucket.",
                )
            prog = self.program_for(self.buckets[-1], noisy=key is not None)
            return prog.reference_forward(
                x, weights, key=key, return_stats=return_stats
            )
        self.hits += 1
        self.pad_waste_rows += pb - b
        if obs_metrics.active():
            obs_metrics.inc(
                "fabric_bucket_hits_total",
                help="Requests served via a bucketed fused graph program.",
            )
            if pb > b:
                obs_metrics.inc(
                    "fabric_pad_waste_rows_total", pb - b,
                    help="Zero-pad rows added by bucket rounding.",
                )
        prog = self.program_for(pb, noisy=key is not None)
        if pb > b:
            pad = torch.zeros((pb - b,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
            x = torch.cat([x, pad], dim=0)
        return prog(
            x, weights, key=key, return_stats=return_stats,
            real_rows=b if pb > b else None,
        )

    def stats(self) -> dict:
        """Host-side counter snapshot (mirrors the obs counters)."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "pad_waste_rows": self.pad_waste_rows,
            "compiles": self.compiles,
            "evictions": self.evictions,
            "resident_programs": len(self._programs),
            "buckets": list(self.buckets),
        }


@dataclasses.dataclass(frozen=True)
class AutotunePlan:
    """One feasible point of the mesh x bucket search, cost-model priced.

    ``expected_latency_s`` is the request-mix-weighted overlapped mesh
    latency of one fused forward per request (each request priced at its
    bucket's padded batch); ``baseline_latency_s`` prices the same mix on
    the default mesh with one max-batch bucket (the cheapest feasible
    single-bucket plan when the default mesh is ineligible).
    ``speedup_vs_baseline`` >= 1 by construction — the baseline is in the
    search space."""

    data: int
    model: int
    buckets: Tuple[int, ...]
    expected_latency_s: float
    baseline_latency_s: float
    searched: int

    @property
    def mesh(self) -> Tuple[int, int]:
        return (self.data, self.model)

    @property
    def speedup_vs_baseline(self) -> float:
        if self.expected_latency_s <= 0:
            return 1.0
        return self.baseline_latency_s / self.expected_latency_s


def _bucket_candidates(hist: Mapping[int, int], data: int) -> List[Tuple[int, ...]]:
    """Candidate bucket boundary sets for a mesh with data axis ``data``:
    the exact-fit quantile set (every observed batch rounded up to the
    axis), power-of-two multiples of the axis, and the single max bucket —
    all padded-batch multiples of ``data`` by construction."""

    def up(b: int) -> int:
        return ((b + data - 1) // data) * data

    maxb = up(max(hist))
    exact = tuple(sorted({up(b) for b in hist}))
    pow2 = []
    m = 1
    while data * m < maxb:
        pow2.append(data * m)
        m *= 2
    pow2.append(maxb)
    cands = {exact, tuple(pow2), (maxb,)}
    return sorted(cands)


def autotune_plan(
    cfg: ModelConfig,
    hist: Mapping[int, int],
    n_chips: int,
    fabric: FabricConfig,
    seq: int = 1,
    cim: Optional[CiMConfig] = None,
    default_mesh: Optional[Tuple[int, int]] = None,
    max_buckets: int = 8,
) -> AutotunePlan:
    """Search mesh shapes x bucket boundaries for the cheapest feasible
    serving plan under the graph cost model.

    Candidate meshes are every ``(data, model)`` factorization of
    ``n_chips``; a mesh is feasible only when :func:`graph_eligibility`
    returns no problems for the model's sharded forward graph on it (this
    is what rejects e.g. GQA-violating model axes, ``n_heads % model``).
    Candidate bucket sets come from the histogram (exact-fit quantiles,
    power-of-two multiples of the data axis, single max bucket), capped at
    ``max_buckets`` boundaries. Cost of a plan = sum over the histogram of
    ``count * overlapped_latency_s`` of one fused forward at the request's
    padded-bucket batch, normalized per request.

    ``default_mesh`` (default ``(1, n_chips)``) with the single max bucket
    is always evaluated as the baseline; since it is also a search
    candidate, ``plan.expected_latency_s <= plan.baseline_latency_s``.

    Example::

        >>> from repro_torch.fabric import FabricConfig  # doctest: +SKIP
        >>> plan = autotune_plan(cfg, {1: 5, 3: 10}, 4, FabricConfig(mode="pair_sar"))  # doctest: +SKIP
        >>> plan.mesh, plan.buckets  # doctest: +SKIP
        ((2, 2), (2, 4))
    """
    if not hist:
        raise ValueError("autotune_plan needs a non-empty request histogram")
    if n_chips < 1:
        raise ValueError(f"n_chips must be >= 1, got {n_chips}")
    if default_mesh is None:
        default_mesh = (1, n_chips)
    total = sum(hist.values())

    lat_cache: Dict[Tuple[int, int, int], float] = {}
    elig_cache: Dict[Tuple[int, int], bool] = {}

    def feasible(d: int, m: int) -> bool:
        if (d, m) not in elig_cache:
            cm = ChipMeshConfig(data=d, model=m, fabric=fabric)
            graph, placements = shard_forward_graph(
                cfg, cm, tokens=d * seq, cim=cim
            )
            elig_cache[(d, m)] = not graph_eligibility(graph, placements, cm)
        return elig_cache[(d, m)]

    def bucket_latency(d: int, m: int, pb: int) -> float:
        if (d, m, pb) not in lat_cache:
            cm = ChipMeshConfig(data=d, model=m, fabric=fabric)
            _, placements = shard_forward_graph(
                cfg, cm, tokens=pb * seq, cim=cim
            )
            lat = overlapped_mesh_latency(placements)
            lat_cache[(d, m, pb)] = lat["overlapped_latency_s"]
        return lat_cache[(d, m, pb)]

    def plan_cost(d: int, m: int, buckets: Tuple[int, ...]) -> float:
        cost = 0.0
        for b, count in hist.items():
            pb = next((bb for bb in buckets if bb >= b), None)
            if pb is None:  # pragma: no cover — candidate sets cover maxb
                return float("inf")
            cost += count * bucket_latency(d, m, pb)
        return cost / total

    meshes = [
        (d, n_chips // d) for d in range(1, n_chips + 1) if n_chips % d == 0
    ]
    searched = 0
    best: Optional[Tuple[float, int, Tuple[int, int], Tuple[int, ...]]] = None
    baseline_cost = float("inf")
    single_cost = float("inf")  # cheapest feasible single-max-bucket plan
    for d, m in meshes:
        if not feasible(d, m):
            continue
        for buckets in _bucket_candidates(hist, d):
            if len(buckets) > max_buckets:
                continue
            searched += 1
            cost = plan_cost(d, m, buckets)
            if len(buckets) == 1:
                single_cost = min(single_cost, cost)
                if (d, m) == tuple(default_mesh):
                    baseline_cost = min(baseline_cost, cost)
            # tie-break: fewer buckets (fewer compiles), then smaller data
            # axis (less padding exposure) — deterministic across runs
            cand = (cost, len(buckets), (d, m), buckets)
            if best is None or cand < best:
                best = cand
    if best is None:
        raise ValueError(
            f"no feasible (data x model) mesh for {cfg.name} on {n_chips} "
            f"chip(s) — graph_eligibility rejected every factorization"
        )
    cost, _, (d, m), buckets = best
    if baseline_cost == float("inf"):
        # default mesh is ineligible for this model — anchor the baseline at
        # the cheapest feasible un-bucketed (single max-batch) plan instead,
        # keeping plan cost <= baseline by construction
        baseline_cost = single_cost
    return AutotunePlan(
        data=d, model=m, buckets=buckets,
        expected_latency_s=cost, baseline_latency_s=baseline_cost,
        searched=searched,
    )


def autotune_section(
    plan: AutotunePlan, cache: Optional[BucketedGraphCache] = None
) -> dict:
    """The serve rollup's ``autotune`` report section: the chosen plan plus
    (when a cache is live) its bucket hit/miss/pad-waste counters —
    rendered by ``fabric.report.render_markdown`` alongside the mesh
    totals."""
    out = {
        "mesh": f"{plan.data}x{plan.model}",
        "buckets": list(plan.buckets),
        "expected_latency_s": plan.expected_latency_s,
        "baseline_latency_s": plan.baseline_latency_s,
        "speedup_vs_baseline": plan.speedup_vs_baseline,
        "searched": plan.searched,
    }
    if cache is not None:
        out["cache"] = cache.stats()
    return out
