"""Shard mapped CiM fabrics across a mesh of chips (counterpart of
``repro.fabric.shard``).

One chip (``FabricConfig``) holds a bounded number of resident weight tiles;
a *mesh* of such chips (:class:`repro_torch.fabric.topology.ChipMeshConfig`)
holds more:

  * ``model`` axis — a layer's K-parallel reduction tiles are split across
    chips at ``rows`` boundaries. Each chip digitizes the partial
    product-sums of its own K-slice locally; the digital partials are
    combined with a ring **reduce-scatter** over the inter-chip links — the
    only new traffic the mesh introduces, priced separately from on-chip EMA
    in ``fabric.report``.
  * ``data`` axis — chips hold weight copies and split the batch (M); no
    cross-chip combine is needed.

The split is planned with ``launch.shardings.spec_for`` (logical ``tp`` ->
mesh ``model``, ``dp`` -> ``data``), and any dimension that does not divide
its axis falls back to replication *with the fallback recorded*. Planning
reads the mesh's shape only, so a mesh of any size plans, 16 chips
included.

Numerics: :func:`execute_sharded_matmul` mirrors ``fabric.execute`` —
fabric-level quantization once, then each chip's block through
``fabric.tiles.column_tile_matmul``: in ``fake_quant`` one CiM fake-quant
kernel launch (K1) per chip block on a CUDA tensor, in ``bitplane`` the
per-plane path with per-chip, per-tile and per-row noise keys. On a 1x1 mesh
it is bit for bit the unsharded ``execute_matmul``.

Execution backends: every chip of the mesh runs on one torch device, one
chip after another, in one loop that sums the partials in chip order. The
JAX package has two (``"sequential"``, its host loop over chips, and
``"shard_map"``, its SPMD chip function); the port keeps both names, and
their eligibility rules and fallbacks, for the callers and reports that
carry them, and runs the same loop for both, so they give equal tensors.
``"auto"`` (default) resolves to ``shard_map`` when the plan has no
replication fallbacks and more than one chip, else to ``sequential``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.core.cim_linear import CimStats, CiMConfig, quantize_symmetric
from repro_torch.fabric.mapper import LayerPlacement, map_matmul, model_matmuls
from repro_torch.fabric.tiles import column_tile_matmul
from repro_torch.fabric.topology import ChipMeshConfig
from repro_torch.launch import shardings as sh
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.fallback import REASON_RAGGED_BATCH, classify_fallback, record_fallback

__all__ = [
    "ShardedPlacement",
    "shard_placement",
    "shard_model",
    "resolve_backend",
    "execute_sharded_matmul",
]

BACKENDS = ("auto", "sequential", "shard_map")


@dataclasses.dataclass
class ShardedPlacement:
    """One layer's placement on a chip mesh, plus its cross-chip costs.

    ``chip`` is the per-chip :class:`~repro_torch.fabric.mapper.LayerPlacement`
    of the K/M shard every chip actually executes (on a 1x1 mesh it is the
    whole layer). ``k_splits`` / ``d_splits`` are the *realized* split
    factors — equal to the mesh axes when the tile/batch counts divide, 1
    (replication) when they don't, with each fallback recorded in
    ``fallbacks``.

    Example::

        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, shard_placement, map_matmul
        >>> cm = ChipMeshConfig(model=2, fabric=FabricConfig(mode="pair_sar", n_arrays=8))
        >>> sp = shard_placement(map_matmul("l", 4, 64, 64, cm.fabric), cm)
        >>> sp.k_splits, sp.chip.k_tiles, sp.crosschip_bits_per_pass > 0
        (2, 2, True)
    """

    name: str
    m: int
    k: int
    n: int
    chip_mesh: ChipMeshConfig
    chip: LayerPlacement  # what ONE chip runs (K/M shard mapped on its fabric)
    k_splits: int  # chips combining partial sums over the model axis
    d_splits: int  # batch shards over the data axis
    fallbacks: List[str]

    @property
    def crosschip_bits_per_pass(self) -> int:
        """Total bits crossing chip links per forward pass: a ring
        reduce-scatter over ``k_splits`` chips moves ``(C-1)/C`` of each
        chip's (M_shard, N) partial-sum block, summed over chips and repeated
        per data-shard group — ``(C-1) * M * N * psum_bits`` in total."""
        if self.k_splits <= 1:
            return 0
        return (self.k_splits - 1) * self.m * self.n * self.chip_mesh.psum_bits

    @property
    def crosschip_energy_pj(self) -> float:
        return self.crosschip_bits_per_pass * self.chip_mesh.link_pj_per_bit

    @property
    def crosschip_latency_s(self) -> float:
        """Link time of the reduce-scatter: rings run in parallel across data
        groups, so the critical path is one chip's send volume."""
        if self.k_splits <= 1:
            return 0.0
        per_chip = (
            (self.k_splits - 1)
            / self.k_splits
            * (self.m // self.d_splits)
            * self.n
            * self.chip_mesh.psum_bits
        )
        return per_chip / self.chip_mesh.link_bits_per_s

    @property
    def n_chips_active(self) -> int:
        return self.k_splits * self.d_splits


def _k_slice(k: int, rows: int, k_tiles: int, k_splits: int, c: int) -> tuple:
    """Element range [k0, k1) of K-shard ``c`` (tile-granular, ragged tail)."""
    tiles_per = k_tiles // k_splits
    return c * tiles_per * rows, min(k, (c + 1) * tiles_per * rows)


def shard_placement(
    placement: LayerPlacement,
    chip_mesh: ChipMeshConfig,
    array_offset: int = 0,
) -> ShardedPlacement:
    """Partition one mapped layer across the chip mesh.

    K-parallel tiles go over the ``model`` axis, batch rows over ``data``,
    with ``spec_for``'s divisibility rules (and scoped ``record_fallbacks``
    bookkeeping): a K-tile count that does not divide the model axis — or a
    batch that does not divide the data axis — falls back to replication
    for that dimension.

    Example::

        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, map_matmul, shard_placement
        >>> fb = FabricConfig(mode="pair_sar", n_arrays=8)
        >>> sp = shard_placement(map_matmul("l", 4, 64, 64, fb), ChipMeshConfig(model=4, fabric=fb))
        >>> sp.k_splits, sp.chip.k
        (4, 16)
    """
    if placement.fabric != chip_mesh.fabric:
        raise ValueError("placement was mapped on a different FabricConfig than chip_mesh.fabric")
    mesh = chip_mesh.mesh()
    with sh.record_fallbacks() as fallbacks:
        spec = sh.spec_for(
            mesh,
            (placement.k_tiles, placement.m),
            ("tp", "dp"),
            label=f"fabric.shard/{placement.name}",
        )
    k_splits = sh.axes_size(mesh, ("model",)) if spec[0] is not None else 1
    d_splits = sh.axes_size(mesh, ("data",)) if spec[1] is not None else 1

    if k_splits == 1 and d_splits == 1 and array_offset == 0:
        chip = placement  # whole layer on every chip — exactly the 1-chip map
    else:
        k0, k1 = _k_slice(placement.k, placement.fabric.rows, placement.k_tiles, k_splits, 0)
        chip = map_matmul(
            placement.name,
            placement.m // d_splits,
            k1 - k0,
            placement.n,
            chip_mesh.fabric,
            cim=placement.cim,
            array_offset=array_offset,
        )
    return ShardedPlacement(
        name=placement.name,
        m=placement.m,
        k=placement.k,
        n=placement.n,
        chip_mesh=chip_mesh,
        chip=chip,
        k_splits=k_splits,
        d_splits=d_splits,
        fallbacks=fallbacks,
    )


def shard_model(
    cfg: ModelConfig,
    chip_mesh: ChipMeshConfig,
    tokens: int = 1,
    cim: Optional[CiMConfig] = None,
    block_only: bool = False,
    matmuls: Optional[List[tuple]] = None,
) -> List[ShardedPlacement]:
    """Map every linear of ``cfg`` onto the mesh (``map_model`` per
    chip-shard, round-robin array offsets preserved across layers).

    ``matmuls`` overrides the ``(name, M, K, N)`` list (default: all of
    ``model_matmuls``) — ``fabric.program`` passes the forward chain through
    here so both planners share one offset-bookkeeping walk.

    Example::

        >>> from repro_torch.configs.registry import get_config
        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, shard_model
        >>> cm = ChipMeshConfig(model=4, fabric=FabricConfig(mode="hybrid", n_arrays=60))
        >>> sps = shard_model(get_config("smollm-135m"), cm, tokens=4, block_only=True)
        >>> len(sps), sps[0].k_splits
        (7, 4)
    """
    if matmuls is None:
        matmuls = model_matmuls(cfg, tokens, block_only=block_only)
    out: List[ShardedPlacement] = []
    offset = 0
    for name, m, k, n in matmuls:
        p = map_matmul(name, m, k, n, chip_mesh.fabric, cim=cim)
        sp = shard_placement(p, chip_mesh, array_offset=offset)
        offset = (offset + sp.chip.n_weight_tiles) % chip_mesh.fabric.n_compute_arrays
        out.append(sp)
    return out


def _chip_noise_key(key, chip_index: int):
    """Per-chip ADC noise key: ``fold_in(key, chip_index)`` for every chip
    except chip 0, which keeps the caller's key unchanged — so a 1x1 mesh
    reproduces the unsharded path's per-tile ``fold_in(key, nt)`` draws bit
    for bit while every other chip gets an independent stream.

    ``chip_index`` is the K-shard (model-axis) index only: chips along the
    data axis share the key and are told apart by the global row ids
    threaded through ``column_tile_matmul``'s ``row_offset``, which makes
    each batch row's draws invariant to the batch size and data split.
    """
    if key is None:
        return None
    return key if chip_index == 0 else prng.fold_in(key, chip_index)


def resolve_backend(sharded: ShardedPlacement, backend: str = "auto") -> str:
    """Resolve the execution backend for a sharded plan.

    ``shard_map`` needs a plan with no replication fallbacks (the realized
    ``d_splits x k_splits`` must equal the mesh shape, or chips along a
    replicated axis would double-count partial sums). ``"auto"`` falls back
    to ``"sequential"`` when it has some — recorded as a structured fallback
    — and also on a 1x1 mesh, where there is nothing to combine; an explicit
    ``backend="shard_map"`` runs a 1x1 mesh anyway, or raises with the
    reasons when ineligible. The JAX package also needs ``data * model`` jax
    devices; the port runs every chip on one device and has no such
    condition.

    Example::

        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, map_matmul, shard_placement
        >>> fb = FabricConfig(mode="pair_sar", n_arrays=8)
        >>> sp = shard_placement(map_matmul("l", 4, 64, 64, fb), ChipMeshConfig(model=2, fabric=fb))
        >>> resolve_backend(sp, "auto")
        'shard_map'
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; pick from {BACKENDS}")
    if backend == "sequential":
        return "sequential"
    cm = sharded.chip_mesh
    problems = []
    if (sharded.d_splits, sharded.k_splits) != (cm.data, cm.model):
        problems.append(
            f"replication fallbacks leave realized splits "
            f"{sharded.d_splits}x{sharded.k_splits} != mesh {cm.data}x{cm.model}"
        )
    if problems:
        if backend == "shard_map":
            raise ValueError("shard_map backend unavailable: " + "; ".join(problems))
        # auto -> sequential: a real degradation, recorded as a structured
        # fallback (no-op unless repro_torch.obs tracing/metrics are active)
        record_fallback("fabric.shard", classify_fallback(problems), "; ".join(problems))
        return "sequential"
    if backend == "auto" and cm.n_chips == 1:
        return "sequential"  # single chip: nothing to combine
    return "shard_map"


def execute_sharded_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    chip_mesh: ChipMeshConfig,
    cim: CiMConfig,
    sharded: Optional[ShardedPlacement] = None,
    key=None,
    return_stats: bool = False,
    backend: str = "auto",
):
    """``y = x @ w`` executed shard-wise over the chip mesh.

    Quantization scales are global (fabric-level calibration), so every chip
    computes integer partial product-sums over its own K-slice and the
    reduce-scatter combine is a plain digital sum — on a 1x1 mesh the
    operation sequence is identical to ``fabric.execute.execute_matmul`` and
    the result is bit for bit equal (bitplane and fake_quant).

    ``backend`` is resolved as in the JAX package (see
    :func:`resolve_backend`) and named in the trace span; both names run the
    one chip loop, with per-chip ADC noise keys (:func:`_chip_noise_key`) and
    the partials summed in chip order. In ``fake_quant`` each chip block is one
    CiM fake-quant kernel launch on a CUDA tensor (``d_splits x k_splits``
    a call); stats are counted only with ``return_stats`` (the JAX package
    counts on every call, and raises its int32 ``OverflowError`` at
    full-width shapes).

    ``x``: (..., K); ``w``: (K, N), on one device.

    Example::

        >>> from repro_torch.core import prng
        >>> from repro_torch.core.cim_linear import CiMConfig
        >>> from repro_torch.fabric import ChipMeshConfig, FabricConfig, execute_sharded_matmul
        >>> cm = ChipMeshConfig(model=2, fabric=FabricConfig(mode="pair_sar", n_arrays=8))
        >>> cim = CiMConfig(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=False)
        >>> x = prng.normal(prng.PRNGKey(0), (4, 64))
        >>> w = prng.normal(prng.PRNGKey(1), (64, 32))
        >>> tuple(execute_sharded_matmul(x, w, cm, cim).shape)
        (4, 32)
    """
    if cim.mode not in ("bitplane", "fake_quant"):
        raise ValueError(f"fabric execution needs bitplane|fake_quant, got {cim.mode!r}")
    fabric = chip_mesh.fabric
    batch_shape = x.shape[:-1]
    k = x.shape[-1]
    n = w.shape[1]
    xm = x.reshape(-1, k)
    if sharded is None:
        base = map_matmul("matmul", xm.shape[0], k, n, fabric, cim=cim)
        sharded = shard_placement(base, chip_mesh)
    if sharded.chip_mesh != chip_mesh:
        raise ValueError("sharded placement was planned on a different ChipMeshConfig")
    if (sharded.k, sharded.n) != (k, n):
        raise ValueError(f"sharded placement is for K={sharded.k},N={sharded.n}; got K={k},N={n}")
    requested = backend
    backend = resolve_backend(sharded, backend)
    if backend == "shard_map" and xm.shape[0] % sharded.d_splits:
        # as in the JAX package, whose shard_map needs equal row blocks: a
        # ragged runtime batch runs as sequential (last shard takes the
        # remainder), or raises when shard_map was asked for
        if requested == "shard_map":
            raise ValueError(
                f"shard_map backend unavailable: batch rows {xm.shape[0]} are "
                f"not divisible by the data axis ({sharded.d_splits})"
            )
        record_fallback(
            "fabric.shard", REASON_RAGGED_BATCH,
            f"batch rows {xm.shape[0]} % data axis {sharded.d_splits} != 0",
        )
        backend = "sequential"
    if obs_metrics.active():
        # host-side analytic accounting only: the sharded chips jointly
        # perform the same planes x rows x k-tiles x columns of conversions
        # as the unsharded op, and the link bits are the placement's
        # (C-1) * M * N * psum_bits reduce-scatter traffic
        obs_metrics.inc("fabric_matmuls_total", help="Mapped matmuls executed.")
        obs_metrics.inc(
            "fabric_conversions_total",
            cim.a_bits * cim.w_bits * xm.shape[0] * math.ceil(k / fabric.rows) * n,
            help="Analytic ADC conversions per executed matmul "
            "(planes x rows x k-tiles x columns).",
        )
        obs_metrics.inc(
            "fabric_link_bits_total",
            sharded.crosschip_bits_per_pass,
            help="Cross-chip reduce-scatter bits moved per executed matmul.",
        )
    span = obs_trace.span(
        "fabric.shard.matmul",
        layer=sharded.name, m=xm.shape[0], k=k, n=n,
        backend=backend, mesh=f"{sharded.d_splits}x{sharded.k_splits}",
    )
    k_splits, d_splits = sharded.k_splits, sharded.d_splits
    k_tiles = math.ceil(k / fabric.rows)

    with span:
        # fabric-level quantization: global scales, exactly the unsharded
        # front-end
        x_int, sx = quantize_symmetric(xm, cim.a_bits, cim.a_signed)
        w_int, sw = quantize_symmetric(w, cim.w_bits, cim.w_signed, per_axis=-1)

        # one loop runs both backends: chip (d, c) takes its batch rows and
        # its K-slice, and the partials are summed in chip order — the
        # reduce-scatter's digital combine
        m_total = xm.shape[0]
        m_shard = m_total // d_splits if d_splits > 1 else m_total
        conversions = torch.zeros((), dtype=torch.int32, device=xm.device)
        comparisons = torch.zeros((), dtype=torch.int32, device=xm.device)
        data_parts = []
        for d in range(d_splits):
            m0 = d * m_shard
            m1 = (d + 1) * m_shard if d < d_splits - 1 else m_total
            total = None
            for c in range(k_splits):
                k0, k1 = _k_slice(k, fabric.rows, k_tiles, k_splits, c)
                y_c, st = column_tile_matmul(
                    x_int[m0:m1, k0:k1].contiguous(), w_int[k0:k1], cim, fabric.cols,
                    key=_chip_noise_key(key, c), row_offset=m0, count=return_stats,
                )
                if st is not None:
                    conversions = conversions + st.conversions
                    comparisons = comparisons + st.comparisons
                total = y_c if total is None else total + y_c
            data_parts.append(total * sx * sw)
        y_q = torch.cat(data_parts, dim=0)

        if cim.ste:
            y_lin = xm @ w
            y_q = y_lin + (y_q - y_lin).detach()

    y = y_q.reshape(*batch_shape, n)
    if return_stats:
        return y, CimStats(conversions, comparisons)
    return y
