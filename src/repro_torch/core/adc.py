"""Memory-immersed ADC transfer functions (PyTorch).

The PyTorch counterpart of ``repro.core.adc``: behavioral models of the
paper's SRAM-immersed digitization modes,

  * ``sar``      — successive approximation via the neighbor array's capacitive
                   DAC (symmetric balanced search, ``bits`` comparisons).
  * ``sar_asym`` — SAR driven by an asymmetric search tree matched to the MAV
                   distribution (paper Fig. 4; ~3.7 comparisons @ 5 bits).
  * ``flash``    — one-to-many coupling: 2^bits - 1 references generated in
                   parallel by proximal arrays (1 cycle).
  * ``hybrid``   — ``flash_bits`` MSBs in one Flash cycle, remaining bits in
                   SAR (optionally asymmetric per-segment trees), paper Fig. 3.
  * ``ideal``    — noiseless quantizer (oracle).

All converters return ``ADCResult(codes, comparisons, cycles)`` (int32) where
``comparisons`` counts comparator firings (energy) and ``cycles`` counts
sequential comparison cycles (latency).

Non-idealities: input-referred comparator noise (rms volts, fresh per
comparison) and unit-capacitor mismatch of the memory-immersed capacitive DAC
(relative sigma; the DNL/INL of paper Fig. 6). Both draw from threefry keys
(``repro_torch.core.prng``) exactly as the JAX package draws from
``jax.random``, so codes, comparisons and cycles equal the JAX package's
under noise too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core import search_tree as st
from repro_torch.device import divisor, resolve_device

__all__ = [
    "ADCConfig",
    "ADCResult",
    "make_reference_ladder",
    "convert",
    "quantize_ideal",
    "dequantize",
    "measure_transfer",
    "dnl_inl",
    "stack_trees",
]


@dataclasses.dataclass(frozen=True)
class ADCConfig:
    """Static configuration of one memory-immersed ADC instance."""

    bits: int = 5
    vdd: float = 1.0
    n_ref_columns: int = 32  # unit caps (columns) in the reference array
    comparator_sigma: float = 0.0  # input-referred rms noise [V]
    ref_mismatch_sigma: float = 0.0  # relative unit-cap mismatch sigma
    mode: str = "sar"  # sar | sar_asym | flash | hybrid | ideal
    flash_bits: int = 2  # MSBs resolved in the flash phase of hybrid mode

    def __post_init__(self):
        if self.mode not in ("sar", "sar_asym", "flash", "hybrid", "ideal"):
            raise ValueError(f"unknown ADC mode {self.mode!r}")
        if self.n_ref_columns < (1 << self.bits):
            raise ValueError(
                "reference array must have >= 2^bits columns to generate all "
                f"thresholds (got {self.n_ref_columns} < {1 << self.bits})"
            )
        if self.mode == "hybrid" and not (0 < self.flash_bits < self.bits):
            raise ValueError("hybrid mode needs 0 < flash_bits < bits")

    @property
    def n_codes(self) -> int:
        return 1 << self.bits

    @property
    def lsb(self) -> float:
        return self.vdd / self.n_codes


class ADCResult(NamedTuple):
    codes: torch.Tensor  # int32, same shape as input voltage
    comparisons: torch.Tensor  # int32, comparator firings per conversion
    cycles: torch.Tensor  # int32, sequential cycles per conversion


def _no_comparator_noise(sigma: float, key) -> None:
    if sigma > 0.0 and key is None:
        raise ValueError("comparator noise requires a PRNG key")


# ---------------------------------------------------------------------------
# Reference generation (memory-immersed capacitive DAC)
# ---------------------------------------------------------------------------


def _xla_cumsum(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """float32 inclusive prefix sum of a 1-D tensor, summed in the order
    XLA's CPU backend sums ``jnp.cumsum`` (its reduce-window rewrite): blocks
    of ``base`` summed left to right, each block offset by the exclusive
    prefix of the block totals, found the same way."""
    n = x.numel()
    nb = -(-n // base)
    xp = torch.cat([x, x.new_zeros(nb * base - n)]).reshape(nb, base) if nb > 1 else x.reshape(1, n)
    acc = torch.zeros(nb, dtype=x.dtype, device=x.device)
    cols = []
    for j in range(xp.shape[1]):
        acc = acc + xp[:, j]
        cols.append(acc)
    within = torch.stack(cols, dim=1)
    if nb == 1:
        return within.reshape(n)
    incl = _xla_cumsum(within[:, -1], base)
    excl = torch.cat([incl.new_zeros(1), incl[:-1]])
    return (within + excl[:, None]).reshape(-1)[:n]


def make_reference_ladder(cfg: ADCConfig, key=None, device=None) -> torch.Tensor:
    """Boundary voltages (2^bits + 1,) float32 produced by the neighbor CiM
    array, on ``device`` (the key's device when None).

    Boundary ``t`` precharges ``m = round(t * n_cols / 2^bits)`` of the
    neighbor array's column lines to VDD (rest to GND) and charge-shares:
    ``V = VDD * sum(C_precharged) / sum(C_all)``. Unit-cap mismatch (a
    ``key`` with ``ref_mismatch_sigma > 0``) makes the ladder non-uniform —
    the source of DNL/INL in paper Fig. 6; the capacitances' running sum is
    taken in the JAX package's order, so the ladder equals its bit for bit.
    """
    n = cfg.n_ref_columns
    if key is not None and cfg.ref_mismatch_sigma > 0.0:
        key = prng.as_key(key, device)
        caps = 1.0 + cfg.ref_mismatch_sigma * prng.normal(key, (n,))
        csum = _xla_cumsum(torch.clamp(caps, min=float(np.float32(1e-3))))
    else:  # unit caps: integer sums, exact in any order
        csum = torch.cumsum(torch.ones((n,), dtype=torch.float32, device=device), 0)
    csum = torch.cat([csum.new_zeros(1), csum])
    m = np.round(np.arange(cfg.n_codes + 1) * n / cfg.n_codes).astype(np.int64)
    return cfg.vdd * csum[torch.as_tensor(m, device=csum.device)] / csum[n]


# ---------------------------------------------------------------------------
# Ideal quantizer (oracle) and dequantization
# ---------------------------------------------------------------------------


def quantize_ideal(v: torch.Tensor, bits: int, vdd: float = 1.0) -> torch.Tensor:
    """Ideal mid-tread staircase: code k covers [k*LSB, (k+1)*LSB)."""
    n = 1 << bits
    return torch.clamp(torch.floor(v / divisor(vdd, v) * n), 0, n - 1).to(torch.int32)


def dequantize(codes: torch.Tensor, bits: int, vdd: float = 1.0) -> torch.Tensor:
    """Mid-point reconstruction of the code's voltage bin."""
    n = 1 << bits
    return (codes.float() + 0.5) * (vdd / n)


# ---------------------------------------------------------------------------
# Tree table helpers
# ---------------------------------------------------------------------------


def _tree_tables(tree: st.TreeTables, device):
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    return as_t(tree.threshold), as_t(tree.left), as_t(tree.right), int(tree.max_depth)


def stack_trees(trees: Sequence[st.TreeTables], device=None):
    """Pad + stack per-segment trees (hybrid fine phase) into (S, n) int32
    tables; returns ``(thr, left, right, max_depth)``."""
    n_int = max(max(t.threshold.size, 1) for t in trees)
    thr = np.zeros((len(trees), n_int), np.int32)
    left = np.full((len(trees), n_int), -1, np.int32)
    right = np.full((len(trees), n_int), -1, np.int32)
    for s, t in enumerate(trees):
        k = t.threshold.size
        thr[s, :k] = t.threshold
        left[s, :k] = t.left
        right[s, :k] = t.right
    max_depth = max(t.max_depth for t in trees)
    as_t = lambda a: torch.as_tensor(a, device=device)
    return as_t(thr), as_t(left), as_t(right), max_depth


# ---------------------------------------------------------------------------
# Traversal engine (vectorized, lockstep)
# ---------------------------------------------------------------------------


def _noise_source(key: torch.Tensor, sigma: float, shape, key_axis: Optional[int]):
    """``draw(i)``: slice ``i`` of ``sigma * normal(key, (D,) + shape)`` (the
    JAX package's noise tensor of D comparator steps or thresholds), drawn
    one slice at a time. With ``key_axis`` the key is a batch, one key per
    index of that axis of ``shape``, as ``jax.vmap`` over the axis draws."""
    row_shape = tuple(shape) if key_axis is None else tuple(shape[:key_axis]) + tuple(shape[key_axis + 1:])
    n = math.prod(row_shape)
    index = torch.arange(n, dtype=torch.int64, device=key.device).reshape(row_shape)

    def draw(i: int) -> torch.Tensor:
        z = prng.normal_at(key, index + i * n)
        return sigma * (z if key_axis is None else z.movedim(0, key_axis))

    return draw


def _traverse(
    v: torch.Tensor,
    ladder: torch.Tensor,
    thr: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    max_depth: int,
    sigma: float,
    key=None,
    boundary_offset: Optional[torch.Tensor] = None,
    seg: Optional[torch.Tensor] = None,
    key_axis: Optional[int] = None,
):
    """Walk an alphabetic search tree for every element of ``v`` in lockstep.

    ``thr/left/right`` are flat ``(n,)`` tables, or ``(S, n)`` segmented tables
    indexed by ``seg`` (hybrid fine phase). ``boundary_offset`` shifts the
    code-boundary index (per element) before the ladder lookup. Step ``i``
    compares ``v + noise[i]`` with the boundary, ``noise = sigma *
    normal(key, (max_depth,) + v.shape)`` (per ``key_axis`` slice with a
    batch of keys); noiseless (``sigma == 0``) the walk compares ``v`` itself
    and no noise is drawn. Returns ``(codes, comparisons)``, int32.
    """
    if max_depth == 0:
        z = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
        return z, z
    _no_comparator_noise(sigma, key)
    draw = _noise_source(key, sigma, v.shape, key_axis) if sigma > 0.0 else None

    ref = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    ncmp = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    segmented = thr.dim() == 2

    def lookup(table, node):
        return table[seg, node] if segmented else table[node]

    for i in range(max_depth):
        is_internal = ref >= 0
        node = torch.clamp(ref, min=0)
        t = lookup(thr, node)
        if boundary_offset is not None:
            t = t + boundary_offset
        go_right = (v if draw is None else v + draw(i)) >= ladder[t]
        nxt = torch.where(go_right, lookup(right, node), lookup(left, node))
        ref = torch.where(is_internal, nxt, ref)
        ncmp += is_internal
    return -ref - 1, ncmp


def _count_fired(v: torch.Tensor, thresholds: torch.Tensor, draw=None) -> torch.Tensor:
    """Number of ``thresholds`` that ``v`` (plus ``draw(i)`` at threshold
    ``i``, with noise) reaches — a bank of parallel comparators; int32, one
    threshold at a time, never a ``(len(thresholds),) + v.shape`` tensor."""
    fired = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    for i in range(thresholds.numel()):
        fired += (v if draw is None else v + draw(i)) >= thresholds[i]
    return fired


# ---------------------------------------------------------------------------
# Conversion front-ends
# ---------------------------------------------------------------------------


def convert(
    v: torch.Tensor,
    cfg: ADCConfig,
    key=None,
    tree: Optional[st.TreeTables] = None,
    ladder: Optional[torch.Tensor] = None,
    fine_trees: Optional[Sequence[st.TreeTables]] = None,
    key_axis: Optional[int] = None,
) -> ADCResult:
    """Digitize analog MAV voltages ``v`` under the configured mode.

    ``tree`` supplies the asymmetric search tree for ``sar_asym``;
    ``fine_trees`` optionally supplies 2^flash_bits per-segment asymmetric
    trees for the hybrid fine phase. ``ladder`` overrides reference
    generation (e.g. to reuse one mismatch draw across conversions).
    ``key`` (a threefry key, ``core.prng``) is split into the ladder's
    mismatch key and the comparators' key, as in the JAX package. With
    ``key_axis``, ``key`` is a batch of keys, one per index of that axis of
    ``v``, and the result equals ``jax.vmap`` of the JAX ``convert`` over
    the axis; such a batch needs an explicit shared ``ladder``.
    """
    v = torch.as_tensor(v)
    mismatch_key = cmp_key = None
    if key is not None:
        key = prng.as_key(key, v.device)
        want = (2,) if key_axis is None else (v.shape[key_axis], 2)
        if tuple(key.shape) != want:
            raise ValueError(f"key of shape {tuple(key.shape)}; want {want} for key_axis={key_axis}")
        mismatch_key, cmp_key = prng.split(key).unbind(-2)
    if ladder is None:
        if key_axis is not None:
            raise ValueError("a batch of keys needs one shared ladder")
        ladder = make_reference_ladder(cfg, mismatch_key, device=v.device)
    sigma = cfg.comparator_sigma
    i32 = dict(dtype=torch.int32, device=v.device)

    if cfg.mode == "ideal":
        codes = quantize_ideal(v, cfg.bits, cfg.vdd)
        z = torch.zeros(v.shape, **i32)
        return ADCResult(codes, z, z)

    if cfg.mode == "flash":
        n = cfg.n_codes
        _no_comparator_noise(sigma, cmp_key)
        draw = _noise_source(cmp_key, sigma, v.shape, key_axis) if sigma > 0.0 else None
        codes = _count_fired(v, ladder[1:n], draw)  # boundaries 1..n-1
        return ADCResult(codes, torch.full(v.shape, n - 1, **i32), torch.ones(v.shape, **i32))

    if cfg.mode in ("sar", "sar_asym"):
        if cfg.mode == "sar" or tree is None:
            tree = tree or st.symmetric_tree(cfg.bits)
        thr, left, right, max_depth = _tree_tables(tree, v.device)
        codes, ncmp = _traverse(v, ladder, thr, left, right, max_depth, sigma, cmp_key, key_axis=key_axis)
        return ADCResult(codes, ncmp, ncmp)

    # hybrid: flash on the top flash_bits, then SAR within the segment
    f = cfg.flash_bits
    n_seg = 1 << f
    seg_size = 1 << (cfg.bits - f)
    k1 = k2 = None
    if cmp_key is not None:
        k1, k2 = prng.split(cmp_key).unbind(-2)
    _no_comparator_noise(sigma, k1)
    draw = _noise_source(k1, sigma, v.shape, key_axis) if sigma > 0.0 else None
    coarse = torch.as_tensor(np.arange(1, n_seg) * seg_size, device=v.device)  # ladder indices
    seg = _count_fired(v, ladder[coarse], draw)

    if fine_trees is not None:
        if len(fine_trees) != n_seg:
            raise ValueError(f"need {n_seg} fine trees, got {len(fine_trees)}")
        thr, left, right, max_depth = stack_trees(fine_trees, v.device)
    else:
        thr, left, right, max_depth = _tree_tables(st.symmetric_tree(cfg.bits - f), v.device)
    fine_codes, fine_cmp = _traverse(
        v, ladder, thr, left, right, max_depth, sigma, k2,
        boundary_offset=seg * seg_size,
        seg=seg if fine_trees is not None else None,
        key_axis=key_axis,
    )
    codes = seg * seg_size + fine_codes
    comparisons = (n_seg - 1) + fine_cmp  # every flash comparator fires
    cycles = 1 + fine_cmp  # flash phase is one cycle
    return ADCResult(codes, comparisons, cycles)


# ---------------------------------------------------------------------------
# Static characterization (paper Fig. 6): staircase, DNL, INL
# ---------------------------------------------------------------------------


def _ramp(stop: float, num: int) -> torch.Tensor:
    """float32 ramp from 0 to ``stop`` in ``num`` points, equal bit for bit to
    the JAX package's ``jnp.linspace(0.0, stop, num)`` as XLA compiles it: the
    divide by ``num - 1`` becomes a multiply by its float32 reciprocal, folded
    with ``stop`` into one constant, and the end point is appended exactly."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    step = f32(stop) * (f32(1.0) / f32(num - 1))
    return torch.cat([torch.arange(num - 1, dtype=torch.float32) * step, f32(stop).reshape(1)])


def measure_transfer(
    cfg: ADCConfig,
    key=None,
    n_points: int = 8192,
    tree: Optional[st.TreeTables] = None,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Sweep a voltage ramp on ``device`` (CUDA unless the caller asks for
    the CPU); return (ramp voltages, output codes) as numpy arrays."""
    ramp = _ramp(cfg.vdd * (1 - 1e-6), n_points).to(resolve_device(device))
    res = convert(ramp, cfg, key=key, tree=tree)
    return ramp.cpu().numpy(), res.codes.cpu().numpy()


def dnl_inl(
    ramp: np.ndarray, codes: np.ndarray, cfg: ADCConfig
) -> tuple[np.ndarray, np.ndarray]:
    """Differential/integral non-linearity in LSB from a measured staircase."""
    n = cfg.n_codes
    lsb = cfg.lsb
    edges = np.full(n, np.nan)
    for c in range(1, n):
        idx = np.argmax(codes >= c)
        if codes[idx] >= c:
            edges[c] = ramp[idx]
    widths = np.diff(edges[1:])  # widths of codes 1..n-2
    dnl = widths / lsb - 1.0
    ideal_edges = np.arange(1, n) * lsb
    inl = (edges[1:] - ideal_edges) / lsb
    return dnl, inl
