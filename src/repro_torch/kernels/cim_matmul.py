"""CiM matmuls: the hand-written CUDA kernels and their plain versions.

The PyTorch/CUDA counterparts of the two Pallas kernels of
``repro.kernels.cim_matmul``. The reduction dimension is tiled into
``rows``-sized "CiM arrays":

* fake-quant (``_cim_matmul_kernel_fakequant``): each tile's exact integer
  partial product-sum is quantized with the RMS-equivalent composite step,
  ``round_half_even(partial / step) * step``, and the tiles are summed.
  :func:`cim_matmul_fq` runs ``csrc/cim_matmul_fq.cu`` (int8 tensor-core
  tile dots, rounding by the exact thresholds of :func:`fq_thresholds`,
  split-K over a thread-block cluster at small M, see
  :func:`fq_cluster_size`); ``launches`` counts its launches.
* bit-plane (``_cim_matmul_kernel_bitplane``): every (activation plane,
  weight plane) pair of every tile is an MAV digitized by an ideal ADC,
  reconstructed by floor and recombined with signed powers of two.
  :func:`cim_matmul_bp` runs ``csrc/cim_matmul_bp.cu`` (plane dots on the
  int8 tensor cores, exact integer sums of the codes, see :func:`bp_fast`;
  split-K over a cluster, see :func:`bp_cluster_size`),
  one launch per call; ``bp_launches`` counts its launches.

Each wrapper runs its CUDA kernel on CUDA tensors and its plain version on CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import divisor
from repro_torch.kernels import build, ref
from repro_torch import work

__all__ = [
    "cim_matmul_fq", "cim_matmul_fq_plain", "fq_cluster_size", "fq_thresholds", "launches",
    "cim_matmul_bp", "cim_matmul_bp_plain", "bp_cluster_size", "bp_fast", "bp_launches",
]

launches = 0  # kernel launches by cim_matmul_fq (plain CPU calls do not count)
bp_launches = 0  # kernel launches by cim_matmul_bp (plain CPU calls do not count)


def cim_matmul_fq_plain(
    x_int: torch.Tensor, w_int: torch.Tensor, *, rows: int, step: float
) -> torch.Tensor:
    """Plain PyTorch version: x_int (M, K) @ w_int (K, N), integer-valued,
    K a multiple of ``rows``; float32 (M, N)."""
    m, k = x_int.shape
    n = w_int.shape[1]
    if k % rows:
        raise ValueError(f"K={k} is not a multiple of rows={rows}; pad it first")
    t = k // rows
    partial = torch.einsum(
        "mtr,trn->mtn", x_int.float().reshape(m, t, rows), w_int.float().reshape(t, rows, n)
    )
    step_t = divisor(step, partial)
    return (torch.round(partial / step_t) * step_t).sum(dim=1)


def _fq_work(x_int, w_int, *, rows, step):
    """K1's work for ``op_stats``: the int8 tile dots, int8 operands in and
    float32 out (its bound in ``PERF.md``), whatever the operands' dtype."""
    (m, k), n = x_int.shape, w_int.shape[1]
    return 2.0 * m * k * n, 2.0 * m * k * n, m * k + k * n + 4 * m * n


@work.kernel("cim_matmul_fq", _fq_work)
def cim_matmul_fq(
    x_int: torch.Tensor, w_int: torch.Tensor, *, rows: int, step: float
) -> torch.Tensor:
    """CiM fake-quant matmul of integer-valued ``x_int`` (M, K) and
    ``w_int`` (K, N), K a multiple of ``rows``; returns float32 (M, N).

    CPU tensors take the plain version. CUDA tensors must be contiguous int8
    on one device, and launch the kernel."""
    if x_int.device.type == "cpu" and w_int.device.type == "cpu":
        return cim_matmul_fq_plain(x_int, w_int, rows=rows, step=step)
    return _launch(x_int, w_int, rows, step)


def _lib():
    lib = build.load("cim_matmul_fq")
    fn = lib.cim_matmul_fq
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


MAX_CLUSTER = 8  # CTAs of one cluster that split an output block's tiles
MAX_STEPS = 8192  # largest |q| the kernel's threshold table holds (csrc/cim_matmul_fq.cu)


def fq_cluster_size(m: int, tiles: int) -> int:
    """CTAs per cluster among which the kernel splits the CiM tiles of one
    output block: up to 8 at M <= 64 (decode), where too few output blocks
    fill the card; 1 (no split) above."""
    return min(MAX_CLUSTER, tiles) if m <= 64 else 1


def fq_thresholds(rows: int, step: float, device) -> torch.Tensor:
    """The kernel's rounding table for tiles of ``rows`` int8 products:
    ``thr[i]`` is the least integer p with ``round(fl32(p / step)) >= i - Q - 1``
    (Q the largest |q| of a tile), with ``INT_MIN``/``INT_MAX`` sentinels, so
    ``len(thr) == 2 * Q + 4``. Built once per (rows, step, device) on the CPU
    with the true float32 divide and kept on ``device``."""
    return _thresholds(rows, float(step), torch.device(device))


@functools.lru_cache(maxsize=None)
def _thresholds(rows, step, device) -> torch.Tensor:
    d = torch.tensor(step, dtype=torch.float32)
    q = lambda p: torch.round(p.to(torch.float32) / d).to(torch.int64)  # noqa: E731
    p_max = rows << 14  # |p| <= rows * 128 * 128 for int8 operands
    q_max = int(q(torch.tensor(p_max)))
    if q_max > MAX_STEPS:
        raise ValueError(
            f"cim_matmul_fq: a tile's quantized dot reaches {q_max} steps; the kernel's "
            f"threshold table holds {MAX_STEPS} (rows {rows}, step {step})"
        )
    # least p with q(p) >= j for j in (-Q, Q], by bisection: q(lo) < j <= q(hi)
    j = torch.arange(-q_max + 1, q_max + 1, dtype=torch.int64)
    lo, hi = torch.full_like(j, -p_max), torch.full_like(j, p_max)
    while bool((hi - lo > 1).any()):
        mid = (lo + hi) // 2
        ok = q(mid) >= j
        hi, lo = torch.where(ok, mid, hi), torch.where(ok, lo, mid)
    lo_end = torch.full((2,), torch.iinfo(torch.int32).min, dtype=torch.int64)
    hi_end = torch.full((2,), torch.iinfo(torch.int32).max, dtype=torch.int64)
    table = torch.cat([lo_end, hi, hi_end]).to(torch.int32)
    with torch.inference_mode(False):  # usable outside inference mode too
        return table.to(device)


@functools.lru_cache(maxsize=None)
def _reciprocal(step: float) -> float:
    """fl32(1 / fl32(step)): the multiplier of the kernel's first estimate of a
    tile's quantized dot (the thresholds then make it exact)."""
    return float(np.float32(1.0) / np.float32(step))


def _launch(x: torch.Tensor, w: torch.Tensor, rows: int, step: float) -> torch.Tensor:
    global launches
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"cim_matmul_fq: operands on {x.device} and {w.device}; the kernel "
            f"takes two tensors on one CUDA device (CPU tensors take the plain version)"
        )
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"cim_matmul_fq: the kernel takes int8 operands, got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"cim_matmul_fq: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("cim_matmul_fq: operands must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    if m == 0 or n == 0 or k == 0 or k % rows or not 1 <= rows <= 1024:
        raise ValueError(f"cim_matmul_fq: M={m}, N={n}, K={k} (K a multiple of rows={rows} <= 1024)")
    t = k // rows
    rows16 = -(-rows // 16) * 16  # a tile padded to whole m16n8k16 steps
    if rows16 != rows:  # zero rows add nothing to a tile's dot
        x = F.pad(x.reshape(m, t, rows), (0, rows16 - rows)).reshape(m, t * rows16)
        w = F.pad(w.reshape(t, rows, n), (0, 0, 0, rows16 - rows)).reshape(t * rows16, n)
    ldw = -(-n // 16) * 16  # 16-byte rows for cp.async
    if ldw != n:
        w = F.pad(w, (0, ldw - n))
    x, w = (a if a.data_ptr() % 16 == 0 else a.clone() for a in (x, w))
    thr = fq_thresholds(rows, step, x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = _lib()(
        x.data_ptr(), w.data_ptr(), thr.data_ptr(), out.data_ptr(), m, n, ldw, t, rows16 // 16,
        thr.numel(), _reciprocal(step), step, int(rows << 14 >= 1 << 22), fq_cluster_size(m, t),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"cim_matmul_fq: kernel launch failed with CUDA error {err}")
    launches += 1
    return out


# ---------------------------------------------------------------------------
# Bit-plane CiM matmul
# ---------------------------------------------------------------------------


def cim_matmul_bp_plain(
    x_pat: torch.Tensor, w_pat: torch.Tensor, *, rows: int, adc_bits: int,
    a_bits: int, w_bits: int, a_signed: bool = True, w_signed: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version: ``ref.cim_matmul_ref(mode="bitplane")`` on the
    operands' two's-complement patterns (non-negative, below 2^bits; signed
    integers work too). K a multiple of ``rows``; float32 (M, N)."""
    return ref.cim_matmul_ref(
        x_pat, w_pat, rows=rows, adc_bits=adc_bits, mode="bitplane",
        a_bits=a_bits, w_bits=w_bits, a_signed=a_signed, w_signed=w_signed,
    )


def _bp_work(x_pat, w_pat, *, a_bits, w_bits, **_):
    """K3's work for ``op_stats``: a plane dot per (plane pair, m, k, n),
    uint8 patterns in and float32 out (its algorithm's bound in ``PERF.md``)."""
    (m, k), n = x_pat.shape, w_pat.shape[1]
    dots = 2.0 * a_bits * w_bits * m * k * n
    return dots, dots, m * k + k * n + 4 * m * n


@work.kernel("cim_matmul_bp", _bp_work)
def cim_matmul_bp(
    x_pat: torch.Tensor, w_pat: torch.Tensor, *, rows: int, adc_bits: int,
    a_bits: int, w_bits: int, a_signed: bool = True, w_signed: bool = True,
) -> torch.Tensor:
    """Bit-plane CiM matmul of ``x_pat`` (M, K) and ``w_pat`` (K, N), the
    two's-complement bit patterns of the quantized operands (plane ``p`` is
    bit ``p``); K a multiple of ``rows``; returns float32 (M, N).

    CPU tensors take the plain version. CUDA tensors must be contiguous uint8
    on one device (at most 8 planes each, ``rows <= 1024``), and launch the
    kernel."""
    kw = dict(rows=rows, adc_bits=adc_bits, a_bits=a_bits, w_bits=w_bits, a_signed=a_signed, w_signed=w_signed)
    if x_pat.device.type == "cpu" and w_pat.device.type == "cpu":
        return cim_matmul_bp_plain(x_pat, w_pat, **kw)
    return _launch_bp(x_pat, w_pat, **kw)


BP_MAX_CLUSTER = 8  # CTAs of one cluster that split an output block's tiles (csrc/cim_matmul_bp.cu)
BP_BLOCK = (64, 32)  # output rows and columns per CTA
BP_SMS = 132  # the H100's SMs


def bp_cluster_size(m: int, n: int, tiles: int) -> int:
    """CTAs per cluster among which K3 splits the CiM tiles of one output
    block. At M <= 64 (decode) the output blocks are few: enough CTAs for
    about one per SM, at most 8 and at most the tile count. Above, 1 (no
    split): the output blocks fill the card, and on the H100 a split cost
    more than it saved at most prefill shapes."""
    if m > BP_BLOCK[0]:
        return 1
    blocks = -(-n // BP_BLOCK[1])
    return max(1, min(BP_MAX_CLUSTER, tiles, -(-BP_SMS // blocks)))


def bp_fast(rows: int, adc_bits: int, a_bits: int, w_bits: int, tiles: int) -> bool:
    """Whether K3 takes its FAST epilogue (the fp32 pipes): ``rows`` a power
    of two 2^r with ``adc_bits >= r`` (the code is the plane dot times
    2^(B - r), clamped), ``a_bits + w_bits + adc_bits <= 24`` (a tile's sum
    of signed codes stays an integer below 2^24, exact in float32) and
    ``tiles * 2^(a_bits + w_bits + adc_bits) < 2^31`` (the totals fit int32).
    Otherwise it takes its INT epilogue: the plain version's own code, IEEE
    divide included, summed in int64."""
    r = rows.bit_length() - 1
    wide = a_bits + w_bits + adc_bits
    return rows == 1 << r and adc_bits >= r and wide <= 24 and tiles << wide < 1 << 31


def _bp_lib():
    lib = build.load("cim_matmul_bp")
    fn = lib.cim_matmul_bp
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [ctypes.c_float] + [ctypes.c_int]
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _launch_bp(x, w, *, rows, adc_bits, a_bits, w_bits, a_signed, w_signed):
    global bp_launches
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"cim_matmul_bp: operands on {x.device} and {w.device}; the kernel "
            f"takes two tensors on one CUDA device (CPU tensors take the plain version)"
        )
    if x.dtype != torch.uint8 or w.dtype != torch.uint8:
        raise TypeError(f"cim_matmul_bp: the kernel takes uint8 bit patterns, got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"cim_matmul_bp: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("cim_matmul_bp: operands must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    if m == 0 or n == 0 or k == 0 or k % rows:
        raise ValueError(f"cim_matmul_bp: M={m}, N={n}, K={k} (K a multiple of rows={rows})")
    if not (1 <= a_bits <= 8 and 1 <= w_bits <= 8 and 1 <= rows <= 1024 and 1 <= adc_bits <= 24):
        raise ValueError(
            f"cim_matmul_bp: the kernel takes 1..8 planes a side, rows <= 1024 and adc_bits <= 24; "
            f"got a_bits={a_bits}, w_bits={w_bits}, rows={rows}, adc_bits={adc_bits}"
        )
    t = k // rows
    rows16 = -(-rows // 16) * 16  # a tile padded to whole m16n8k16 steps
    if rows16 != rows:  # zero rows add nothing to a plane dot
        x = F.pad(x.reshape(m, t, rows), (0, rows16 - rows)).reshape(m, t * rows16)
        w = F.pad(w.reshape(t, rows, n), (0, 0, 0, rows16 - rows)).reshape(t * rows16, n)
    ldw = -(-n // 16) * 16  # 16-byte rows for cp.async
    if ldw != n:
        w = F.pad(w, (0, ldw - n))
    x, w = (a if a.data_ptr() % 16 == 0 else a.clone() for a in (x, w))
    fast = bp_fast(rows, adc_bits, a_bits, w_bits, t)
    q = 2.0 ** (adc_bits - (rows.bit_length() - 1)) if fast else 0.0
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = _bp_lib()(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, ldw, t, rows, rows16, a_bits, w_bits,
        int(a_signed), int(w_signed), adc_bits, int(fast), q,
        bp_cluster_size(m, n, t), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"cim_matmul_bp: kernel launch failed with CUDA error {err}")
    bp_launches += 1  # one launch per call: the cluster split-K needs no second pass
    return out
