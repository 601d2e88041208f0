"""Whole-model fused forward over the chip mesh (counterpart of
``repro.fabric.program``).

``fabric.shard.execute_sharded_matmul`` runs one matmul at a time: every layer
gathers its combined output, re-scatters it as the next layer's input, and
pays a Python dispatch. This module runs the model's forward chain
(``mapper.model_forward_chain``) as one program over the mesh, the JAX
package's fused ``shard_map`` chip function run for every chip on one torch
device:

  * layer i's reduce-scatter output **stays sharded** as layer i+1's input —
    the reduce-scatter leaves chip ``c`` holding exactly the output columns
    that are its K-slice of the next layer (tile-aligned by construction), so
    no gather/re-scatter happens between layers and ONE ``all_gather`` at the
    very end produces the full output;
  * inter-layer re-quantization stays sharded too: the global activation
    abs-max is a ``pmax`` over the mesh (max of shard maxes IS the global
    max, exactly) and the scale a true IEEE divide by ``qmax``
    (``repro_torch.device.divisor``), so the fused program quantizes bit for
    bit as the per-layer loop's ``quantize_symmetric``;
  * per-layer ADC noise keys are ``fold_in(key, layer_index)``, then
    per-chip / per-tile / per-row like every other executor
    (``fabric.tiles``).

The collectives are ``fabric.collectives``' reductions over the chip axis,
summed in chip order, as the per-layer loop sums: the fused program equals
the per-layer ``execute_sharded_matmul`` loop bit for bit on every mesh,
noisy ADC included. In ``fake_quant`` every chip's block of every layer is
one CiM fake-quant kernel launch (K1) on a CUDA tensor: ``L x data x model``
launches a forward.

:func:`measure_forward` times the fused program, an identical program with
the collectives stripped (so the difference is the collectives' time) and
the per-layer loop, each call between ``torch.cuda.synchronize()``s on a
CUDA device, and reports the measured collective seconds next to
``overlapped_mesh_latency``'s modeled link time
(``fabric.pipeline.link_validation``). The two live in different clock
domains, so their ratio is a calibration constant, not a number expected to
be 1.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.core.cim_linear import CimStats, CiMConfig, quantize_symmetric
from repro_torch.device import divisor, resolve_device, synchronize
from repro_torch.fabric import collectives as coll
from repro_torch.fabric.mapper import model_forward_chain
from repro_torch.fabric.shard import ShardedPlacement, _chip_noise_key, execute_sharded_matmul, shard_model
from repro_torch.fabric.tiles import column_tile_matmul
from repro_torch.fabric.topology import ChipMeshConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.fallback import (
    REASON_RAGGED_BATCH,
    REASON_REQUESTED_SEQUENTIAL,
    classify_fallback,
    record_fallback,
)

__all__ = [
    "FabricProgram",
    "compile_forward",
    "per_layer_forward",
    "measure_forward",
    "program_eligibility",
]


def _record_request(component: str, program, m: int, fused: bool) -> None:
    """Host-side per-request accounting: one ``fabric_requests_total{path=...}``
    increment, plus — on the fused path only, whose collectives never pass
    through ``execute_sharded_matmul`` — the analytic conversion/link-bit
    totals the per-layer loop would otherwise record matmul by matmul. No-op
    when metrics collection is inactive."""
    if not obs_metrics.active():
        return
    obs_metrics.inc(
        "fabric_requests_total",
        help="Forward requests by execution path (fused shard_map vs fallback loop).",
        path="fused" if fused else "fallback",
    )
    if fused:
        cim = program.cim
        rows = program.chip_mesh.fabric.rows
        obs_metrics.inc("fabric_matmuls_total", len(program.placements), help="Mapped matmuls executed.")
        obs_metrics.inc(
            "fabric_conversions_total",
            sum(cim.a_bits * cim.w_bits * m * math.ceil(sp.k / rows) * sp.n for sp in program.placements),
            help="Analytic ADC conversions per executed matmul "
            "(planes x rows x k-tiles x columns).",
        )
        obs_metrics.inc(
            "fabric_link_bits_total",
            # crosschip_bits_per_pass is priced at the placement's planned M;
            # scale to the rows actually served — exact, since the bits are
            # (k_splits-1) * M * N * psum_bits, linear in M
            sum(sp.crosschip_bits_per_pass * m // sp.m for sp in program.placements),
            help="Cross-chip reduce-scatter bits moved per executed matmul.",
        )


def _record_request_fallback(component: str, program, detail: str = "") -> None:
    """Classify and emit the structured fallback record for a request that
    left the fused path (``__call__``'s sequential branches)."""
    if program.problems:
        reason = classify_fallback(program.problems)
        detail = detail or "; ".join(program.problems)
    elif program.requested_backend == "sequential":
        reason = REASON_REQUESTED_SEQUENTIAL
    else:
        reason = REASON_RAGGED_BATCH
    record_fallback(component, reason, detail)


def shard_forward_chain(
    cfg: ModelConfig,
    chip_mesh: ChipMeshConfig,
    tokens: int = 1,
    cim: Optional[CiMConfig] = None,
    block_only: bool = False,
) -> List[ShardedPlacement]:
    """Shard the model's forward chain (``mapper.model_forward_chain``) onto
    the mesh — ``shard_model``'s own offset-bookkeeping walk, restricted to
    the chained linears the fused program can run end to end."""
    return shard_model(
        cfg, chip_mesh, tokens=tokens, cim=cim,
        matmuls=model_forward_chain(cfg, tokens, block_only=block_only),
    )


def program_eligibility(placements: Sequence[ShardedPlacement], chip_mesh: ChipMeshConfig) -> List[str]:
    """Why the fused program can('t) run this chain. Empty = eligible.

    Beyond ``resolve_backend``'s per-layer condition (no replication
    fallbacks), the fusion needs the *chain* invariants: layer i's N is
    layer i+1's K; every K tile-aligns with the mesh (``K % (model * rows)
    == 0``, so the reduce-scatter hands each chip a whole-tile K-slice) and
    every N splits evenly for the tiled reduce-scatter (``N % model == 0``).
    The JAX package also needs ``data * model`` jax devices; the port runs
    every chip on one device.

    Example::

        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, map_matmul, shard_placement
        >>> fb = FabricConfig(mode="pair_sar", n_arrays=8)
        >>> cm = ChipMeshConfig(model=2, fabric=fb)
        >>> sps = [shard_placement(map_matmul("l", 4, 64, 64, fb), cm)]
        >>> program_eligibility(sps, cm)
        []
    """
    problems: List[str] = []
    if not placements:
        return ["empty layer chain"]
    fabric = chip_mesh.fabric
    prev = None
    for i, sp in enumerate(placements):
        if sp.chip_mesh != chip_mesh:
            problems.append(f"layer {i} ({sp.name}) was planned on a different mesh")
            continue
        if (sp.d_splits, sp.k_splits) != (chip_mesh.data, chip_mesh.model):
            problems.append(
                f"layer {i} ({sp.name}) has replication fallbacks: realized "
                f"{sp.d_splits}x{sp.k_splits} != mesh {chip_mesh.data}x{chip_mesh.model}"
            )
        if sp.k % (chip_mesh.model * fabric.rows) != 0:
            problems.append(
                f"layer {i} ({sp.name}) K={sp.k} is not a whole number of "
                f"{fabric.rows}-row tiles per model-axis chip"
            )
        if sp.n % chip_mesh.model != 0:
            problems.append(
                f"layer {i} ({sp.name}) N={sp.n} does not divide the model axis "
                f"({chip_mesh.model}) for the tiled psum_scatter"
            )
        if prev is not None:
            if sp.k != prev.n:
                problems.append(
                    f"chain break at layer {i}: {prev.name} outputs N={prev.n} "
                    f"but {sp.name} consumes K={sp.k}"
                )
            if sp.m != prev.m:
                problems.append(
                    f"batch mismatch at layer {i}: {prev.name} M={prev.m} vs "
                    f"{sp.name} M={sp.m}"
                )
        prev = sp
    return problems


@dataclasses.dataclass
class FabricProgram:
    """A whole-model forward over the chip mesh.

    ``backend`` is the *resolved* execution path: ``"shard_map"`` runs the
    fused program; ``"sequential"`` is the per-layer
    ``execute_sharded_matmul`` loop (the automatic fallback, and the
    reference the fused path is tested bit-exact against). Call it like a
    function::

        y = program(x, weights, key=key)
        y, stats = program(x, weights, return_stats=True)

    ``weights`` is one float ``(K_i, N_i)`` matrix per chained layer
    (:attr:`weight_shapes`); quantization — per-tensor activations,
    per-column weights — matches the per-layer loop exactly.

    Example::

        >>> from repro_torch.core import prng
        >>> from repro_torch.core.cim_linear import CiMConfig
        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, compile_forward, map_matmul, shard_placement
        >>> fb = FabricConfig(mode="pair_sar", n_arrays=8)
        >>> cim = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=False)
        >>> cm = ChipMeshConfig(model=2, fabric=fb)
        >>> chain = [shard_placement(map_matmul("l0", 4, 64, 64, fb, cim=cim), cm),
        ...          shard_placement(map_matmul("l1", 4, 64, 32, fb, cim=cim), cm)]
        >>> prog = compile_forward(chain, cm, cim)
        >>> x = prng.normal(prng.PRNGKey(0), (4, 64))
        >>> prog.backend, tuple(prog(x, prog.random_weights(prng.PRNGKey(1))).shape)
        ('shard_map', (4, 32))
    """

    chip_mesh: ChipMeshConfig
    cim: CiMConfig
    placements: List[ShardedPlacement]
    backend: str  # resolved: "shard_map" | "sequential"
    requested_backend: str
    problems: List[str]  # why the fused path was ineligible (empty when it runs)

    @property
    def n_layers(self) -> int:
        return len(self.placements)

    @property
    def weight_shapes(self) -> List[Tuple[int, int]]:
        return [(sp.k, sp.n) for sp in self.placements]

    @property
    def m(self) -> int:
        return self.placements[0].m

    def random_weights(self, key) -> List[torch.Tensor]:
        """Per-layer standard-normal weights of the chain's shapes
        (``normal(fold_in(key, i), (K_i, N_i))``, the JAX program's draws bit
        for bit), on the key's device — for smokes, examples, tests."""
        return [prng.normal(prng.fold_in(key, i), (k, n)) for i, (k, n) in enumerate(self.weight_shapes)]

    def example_input(self, key) -> torch.Tensor:
        """An ``(M, K0)`` input matching the planned chain shapes, on the
        key's device."""
        return prng.normal(key, (self.m, self.placements[0].k))

    def reference_forward(self, x, weights, key=None, backend: str = "sequential", return_stats: bool = False):
        """The per-layer ``execute_sharded_matmul`` loop on this program's
        placements — what ``measure_forward`` times as the unfused baseline."""
        return per_layer_forward(
            x, weights, self.placements, self.chip_mesh, self.cim,
            key=key, backend=backend, return_stats=return_stats,
        )

    # -- fused program ------------------------------------------------------

    def _fused(self, has_key: bool, collectives: bool = True):
        """Build the fused program: ``fn(xm, qmax_f, *flat) ->
        (y, conversions, comparisons)`` over the weights ``flat`` of
        :meth:`_prepare` (with the key last when ``has_key``).

        ``collectives=False`` builds an identical program with every
        collective replaced by a local stand-in of the same shape —
        numerically wrong by construction, but the same per-chip compute, so
        ``t(fused) - t(local)`` isolates the collectives' time for
        :func:`measure_forward`.
        """
        cm, cim = self.chip_mesh, self.cim
        C, D = cm.model, cm.data
        cols = cm.fabric.cols
        L = self.n_layers
        qmax = (1 << (cim.a_bits - 1)) - 1 if cim.a_signed else (1 << cim.a_bits) - 1
        lo = -qmax - 1 if cim.a_signed else 0

        def fused(xm, qmax_f, *flat, count: bool = True):
            # h: what every chip holds, (data, model, rows, its K-slice)
            m_shard = xm.shape[0] // D
            h = xm.reshape(D, m_shard, C, -1).transpose(1, 2)
            key = flat[2 * L] if has_key else None
            conversions = torch.zeros((D, C), dtype=torch.int32, device=xm.device)
            comparisons = torch.zeros((D, C), dtype=torch.int32, device=xm.device)
            for i in range(L):
                w_int, sw = flat[2 * i], flat[2 * i + 1]
                k_chip, n_chip = w_int.shape[0] // C, w_int.shape[1] // C
                # global activation scale: max of shard maxes == global max,
                # exactly — bit-identical to the loop's quantize_symmetric
                absval = h.abs() if cim.a_signed else torch.clamp(h, min=0)
                absmax = torch.amax(absval, dim=(2, 3))
                if collectives:
                    absmax = coll.pmax(absmax, coll.AXES)
                scale = torch.where(absmax > 0, absmax / qmax_f, torch.ones_like(absmax))[:, :, None, None]
                x_int = torch.clamp(torch.round(h / scale), lo, qmax)
                lkey = prng.fold_in(key, i) if has_key else None
                ys, conv, comp = [], [], []
                for d in range(D):
                    for c in range(C):
                        # K-shard index only: data chips differ via the global
                        # row ids (row_offset), keeping each row's draws
                        # split-invariant
                        y_c, st = column_tile_matmul(
                            x_int[d, c].contiguous(), w_int[c * k_chip:(c + 1) * k_chip], cim, cols,
                            key=_chip_noise_key(lkey, c), row_offset=d * m_shard, count=count,
                        )
                        ys.append(y_c)
                        if st is not None:
                            conv.append(st.conversions)
                            comp.append(st.comparisons)
                y_int = torch.stack(ys).reshape(D, C, m_shard, -1)
                if conv:
                    conversions = conversions + torch.stack(conv).reshape(D, C)
                    comparisons = comparisons + torch.stack(comp).reshape(D, C)
                if C > 1:
                    if collectives:
                        # the inter-layer combine: chip c keeps exactly its
                        # K-slice of the NEXT layer — no gather, no re-scatter
                        y_int = coll.psum_scatter(y_int, "model", scatter_dimension=1)
                    else:
                        y_int = torch.stack(
                            [y_int[:, c, :, c * n_chip:(c + 1) * n_chip] for c in range(C)], dim=1
                        )
                # P(None, "model"): chip c holds its columns of the scales
                h = y_int * scale * sw.reshape(C, n_chip)[None, :, None, :]
            if C > 1:
                if collectives:
                    h = coll.all_gather(h, "model", gather_dimension=1)  # the ONE gather
                else:
                    h = torch.cat([h] * C, dim=3)
            if collectives:
                conversions = coll.psum(conversions, coll.AXES)
                comparisons = coll.psum(comparisons, coll.AXES)
            # P("data", None): the rows of chip (d, 0), in data order
            return h[:, 0].reshape(xm.shape[0], -1), conversions[0, 0], comparisons[0, 0]

        return fused

    def _prepare(self, x, weights, key):
        """Flatten x, quantize the weights (exactly the per-layer loop's
        front-end), and assemble the fused program's argument list."""
        if len(weights) != self.n_layers:
            raise ValueError(f"expected {self.n_layers} weight matrices, got {len(weights)}")
        for i, (w, (k, n)) in enumerate(zip(weights, self.weight_shapes)):
            if tuple(w.shape) != (k, n):
                raise ValueError(
                    f"layer {i} ({self.placements[i].name}) expects weights "
                    f"({k}, {n}), got {tuple(w.shape)}"
                )
        batch_shape = x.shape[:-1]
        k0 = self.placements[0].k
        if x.shape[-1] != k0:
            raise ValueError(f"input features {x.shape[-1]} != chain K={k0}")
        xm = x.reshape(-1, k0)
        qmax = (1 << (self.cim.a_bits - 1)) - 1 if self.cim.a_signed else (1 << self.cim.a_bits) - 1
        # a 0-d device tensor: dividing by it is a true IEEE divide on every
        # device (the JAX program passes its qmax traced for the same reason)
        flat = [divisor(qmax, xm, xm.dtype)]
        for w in weights:
            w_int, sw = quantize_symmetric(w, self.cim.w_bits, self.cim.w_signed, per_axis=-1)
            flat += [w_int, sw]
        if key is not None:
            flat.append(prng.as_key(key, xm.device))
        return batch_shape, xm, flat

    def _fused_args(self, x, weights, key):
        """The fused callable's argument tuple (``measure_forward``)."""
        _, xm, flat = self._prepare(x, weights, key)
        return (xm, *flat)

    def fused_available(self, x) -> bool:
        """Whether the fused path can run THIS input — the resolved backend
        plus ``__call__``'s ragged-batch condition (flattened rows divisible
        by the data axis)."""
        if self.backend != "shard_map":
            return False
        return x.reshape(-1, x.shape[-1]).shape[0] % self.chip_mesh.data == 0

    def __call__(self, x, weights, key=None, return_stats: bool = False):
        if self.backend != "shard_map":
            _record_request_fallback("fabric.program", self)
            _record_request("fabric.program", self, 0, fused=False)
            return per_layer_forward(
                x, weights, self.placements, self.chip_mesh, self.cim,
                key=key, backend="sequential", return_stats=return_stats,
            )
        batch_shape, xm, flat = self._prepare(x, weights, key)
        if xm.shape[0] % self.chip_mesh.data:
            if self.requested_backend == "shard_map":
                raise ValueError(
                    f"fused program unavailable: batch rows {xm.shape[0]} are "
                    f"not divisible by the data axis ({self.chip_mesh.data})"
                )
            record_fallback(
                "fabric.program", REASON_RAGGED_BATCH,
                f"batch rows {xm.shape[0]} % data axis {self.chip_mesh.data} != 0",
            )
            _record_request("fabric.program", self, 0, fused=False)
            return per_layer_forward(
                x, weights, self.placements, self.chip_mesh, self.cim,
                key=key, backend="sequential", return_stats=return_stats,
            )
        _record_request("fabric.program", self, xm.shape[0], fused=True)
        with obs_trace.span(
            "fabric.program.forward", n_layers=self.n_layers,
            mesh=f"{self.chip_mesh.data}x{self.chip_mesh.model}", m=xm.shape[0],
        ):
            y, conversions, comparisons = self._fused(key is not None)(xm, *flat, count=return_stats)
        y = y.reshape(*batch_shape, self.placements[-1].n)
        if return_stats:
            return y, CimStats(conversions, comparisons)
        return y

    # -- introspection ------------------------------------------------------

    def collective_counts(self, x=None, weights=None, key=None, device="cuda") -> dict:
        """The collectives of one fused forward, by the JAX primitive's name
        (``fabric.collectives.census``) — the census that says the whole
        forward holds at most ONE ``all_gather`` (and one ``reduce_scatter``
        per inter-layer combine). Runs the forward once, on ``x`` and
        ``weights`` (zeros on ``device`` by default)."""
        if self.backend != "shard_map":
            raise ValueError("collective_counts needs the shard_map backend")
        if x is None:
            x = torch.zeros((self.m, self.placements[0].k), device=resolve_device(device))
        if weights is None:
            weights = [torch.zeros(s, device=x.device) for s in self.weight_shapes]
        _, xm, flat = self._prepare(x, weights, key)
        with coll.census() as counts:
            self._fused(key is not None)(xm, *flat, count=False)
        return counts


def compile_forward(
    model: Union[ModelConfig, Sequence[ShardedPlacement]],
    chip_mesh: ChipMeshConfig,
    cim: Optional[CiMConfig] = None,
    backend: str = "auto",
    tokens: int = 1,
    block_only: bool = False,
) -> FabricProgram:
    """Plan a whole mapped model as one fused forward over the mesh.

    ``model`` is a :class:`~repro_torch.configs.base.ModelConfig` (its
    forward chain — ``mapper.model_forward_chain`` — is sharded onto the
    mesh with the usual round-robin offsets) or an explicit list of chained
    :class:`~repro_torch.fabric.shard.ShardedPlacement`\\ s. ``backend``
    mirrors ``resolve_backend``: ``"shard_map"`` raises with the reasons
    when the fused program is ineligible (:func:`program_eligibility`),
    ``"auto"`` falls back to the per-layer sequential loop — and fuses even
    on a 1x1 mesh.

    Example::

        >>> from repro_torch.configs.registry import get_config
        >>> from repro_torch.core.cim_linear import CiMConfig
        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, compile_forward
        >>> cm = ChipMeshConfig(model=4, fabric=FabricConfig(mode="hybrid", n_arrays=256))
        >>> prog = compile_forward(get_config("smollm-135m"), cm, CiMConfig(mode="fake_quant", ste=False), tokens=4)
        >>> prog.backend, prog.n_layers
        ('shard_map', 121)
    """
    if backend not in ("auto", "sequential", "shard_map"):
        raise ValueError(f"unknown backend {backend!r}")
    if cim is None:
        cim = CiMConfig(mode="bitplane", adc_bits=chip_mesh.fabric.adc_bits, rows=chip_mesh.fabric.rows, ste=False)
    if cim.mode not in ("bitplane", "fake_quant"):
        raise ValueError(f"fabric execution needs bitplane|fake_quant, got {cim.mode!r}")
    if cim.ste:
        raise ValueError(
            "the fused forward feeds layer outputs straight into the next "
            "layer's quantizer; STE wrapping is a per-matmul training "
            "feature — pass a cim with ste=False"
        )
    if isinstance(model, ModelConfig):
        placements = shard_forward_chain(model, chip_mesh, tokens=tokens, cim=cim, block_only=block_only)
    else:
        placements = list(model)
    problems = program_eligibility(placements, chip_mesh)
    if backend == "sequential":
        resolved = "sequential"
    elif problems:
        if backend == "shard_map":
            raise ValueError("fused shard_map program unavailable: " + "; ".join(problems))
        obs_trace.event("fabric.program.ineligible", problems=list(problems))
        resolved = "sequential"
    else:
        resolved = "shard_map"
    return FabricProgram(
        chip_mesh=chip_mesh,
        cim=cim,
        placements=placements,
        backend=resolved,
        requested_backend=backend,
        problems=problems,
    )


def per_layer_forward(
    x,
    weights,
    placements: Sequence[ShardedPlacement],
    chip_mesh: ChipMeshConfig,
    cim: CiMConfig,
    key=None,
    backend: str = "sequential",
    return_stats: bool = False,
):
    """The reference forward: one ``execute_sharded_matmul`` per layer, with
    the program's per-layer noise keys (``fold_in(key, i)``) — the loop the
    fused program is bit-exact against. Also the measured baseline for the
    per-layer gather + re-scatter + dispatch cost the fusion removes.

    Example::

        >>> from repro_torch.core import prng
        >>> from repro_torch.core.cim_linear import CiMConfig
        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, map_matmul, shard_placement
        >>> fb = FabricConfig(mode="pair_sar", n_arrays=8)
        >>> cim = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=False)
        >>> cm = ChipMeshConfig(fabric=fb)
        >>> sps = [shard_placement(map_matmul("l0", 4, 64, 32, fb, cim=cim), cm)]
        >>> x = prng.normal(prng.PRNGKey(0), (4, 64))
        >>> w = prng.normal(prng.PRNGKey(1), (64, 32))
        >>> tuple(per_layer_forward(x, [w], sps, cm, cim).shape)
        (4, 32)
    """
    if len(weights) != len(placements):
        raise ValueError(f"expected {len(placements)} weight matrices, got {len(weights)}")
    h = x
    conversions = torch.zeros((), dtype=torch.int32, device=x.device)
    comparisons = torch.zeros((), dtype=torch.int32, device=x.device)
    for i, (sp, w) in enumerate(zip(placements, weights)):
        lkey = prng.fold_in(key, i) if key is not None else None
        out = execute_sharded_matmul(
            h, w, chip_mesh, cim, sharded=sp, key=lkey,
            return_stats=return_stats, backend=backend,
        )
        if return_stats:
            h, st = out
            conversions = conversions + st.conversions
            comparisons = comparisons + st.comparisons
        else:
            h = out
    if return_stats:
        return h, CimStats(conversions, comparisons)
    return h


def _time_best(fn, iters: int, device: torch.device) -> float:
    best = float("inf")
    for _ in range(iters):
        synchronize(device)
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


def measure_forward(
    program,
    x=None,
    weights=None,
    key=None,
    iters: int = 2,
    per_layer_backend: Optional[str] = None,
    per_layer_iters: int = 1,
    per_layer: bool = True,
    device="cuda",
) -> dict:
    """Time a fused program and isolate its collectives' time.

    ``program`` is a chain :class:`FabricProgram` or a full-block
    :class:`~repro_torch.fabric.graph.GraphProgram`: both expose the fused
    and collective-stripped programs and a ``reference_forward`` unfused
    baseline. Runs (host clock between ``torch.cuda.synchronize()`` calls on a CUDA
    device; best of ``iters`` after a warm-up): the fused program; an
    identical program with the collectives replaced by local stand-ins of
    the same shapes (so the difference is the collectives' time); and the
    per-layer reference loop (``per_layer_backend`` defaults to the
    program's own backend, timed with ``per_layer_iters``; ``per_layer=False``
    skips it). The measured collective seconds land next to the modeled
    link time via ``fabric.pipeline.link_validation``. ``x`` and
    ``weights`` default to the program's ``example_input`` and
    ``random_weights`` of ``PRNGKey(0)`` / ``PRNGKey(1)`` drawn on
    ``device``.

    Example::

        >>> r = measure_forward(prog)  # doctest: +SKIP
        >>> sorted(r)[:3]  # doctest: +SKIP
        ['backend', 'fused_s', 'local_s']
    """
    from repro_torch.fabric.pipeline import link_validation

    if x is None:
        x = program.example_input(prng.PRNGKey(0, resolve_device(device)))
    if weights is None:
        weights = program.random_weights(prng.PRNGKey(1, x.device))
    dev = x.device

    out = {
        "backend": program.backend,
        "n_layers": program.n_layers,
        "mesh": f"{program.chip_mesh.data}x{program.chip_mesh.model}",
        "n_chips": program.chip_mesh.n_chips,
    }
    measured_collective_s = None
    # fused_available also screens ragged batches (__call__'s fallback),
    # which the fused twins cannot run
    if program.backend == "shard_map" and program.fused_available(x):
        args = program._fused_args(x, weights, key)
        fused = program._fused(key is not None)
        local = program._fused(key is not None, collectives=False)
        fused(*args, count=False)  # warm
        local(*args, count=False)
        out["fused_s"] = _time_best(lambda: fused(*args, count=False), iters, dev)
        out["local_s"] = _time_best(lambda: local(*args, count=False), iters, dev)
        measured_collective_s = max(0.0, out["fused_s"] - out["local_s"])
    if per_layer:
        loop_backend = per_layer_backend or program.backend
        out["per_layer_backend"] = loop_backend

        def reference():
            return program.reference_forward(x, weights, key=key, backend=loop_backend)

        reference()  # warm
        out["per_layer_s"] = _time_best(reference, per_layer_iters, dev)
        if "fused_s" in out:
            out["fused_speedup_vs_per_layer"] = out["per_layer_s"] / max(out["fused_s"], 1e-12)
    out.update(link_validation(program.placements, measured_collective_s))
    return out
