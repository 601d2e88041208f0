"""Causal GQA flash attention, forward: the hand-written CUDA kernel and its
plain version.

The PyTorch/CUDA counterpart of the Pallas kernel
``repro.kernels.flash_attention._flash_kernel`` (``flash_attention_pallas``):
online softmax over KV blocks, absolute ``q_positions`` (so a query shard
masks correctly), KV head ``h // (H / KV)``, KV blocks past a query block's
largest position skipped, fp32 statistics and accumulator, output in q's
dtype.

:func:`flash_attention` keeps ``flash_attention_pallas``'s signature and
checks. It runs the CUDA kernel (``csrc/flash_attention.cu``) on CUDA tensors
and :func:`flash_attention_plain` (the same algorithm over ``block_q`` by
``block_k`` blocks) on CPU tensors; it never falls back from one to the other.
The kernel is chosen by the dtype of k/v before the launch
(:func:`kernel_variant`): bf16 k/v, as on every serve path, take the
tensor-core kernel (32-query blocks over 64-key tiles, float32 operands split
exactly into bf16 pieces); float32 k/v the CUDA-core kernel. ``launches`` counts the
launches of both. It is forward-only, as the JAX package's flash path: under
autograd it raises rather than cut the attention gradients.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch import work

__all__ = ["flash_attention", "flash_attention_plain", "kernel_variant", "launches"]

launches = 0  # kernel launches by flash_attention (plain CPU calls do not count)

_NEG = -1e30
_KERNEL_HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_variant(kv_dtype: torch.dtype) -> str:
    """Which CUDA kernel :func:`flash_attention` launches for k/v of
    ``kv_dtype``: ``"tensor-core"`` (bf16) or ``"cuda-core"`` (float32)."""
    if kv_dtype not in _DTYPES:
        raise TypeError(f"flash_attention: no kernel for k/v of {kv_dtype}")
    return "tensor-core" if kv_dtype == torch.bfloat16 else "cuda-core"


def _check(q, k, v, block_q, block_k):
    h, sq = q.shape[1], q.shape[2]
    kv, sk = k.shape[1], k.shape[2]
    if h % kv:
        raise ValueError("n_heads must be a multiple of n_kv_heads")
    if sq % block_q or sk % block_k:
        raise ValueError("pad Sq/Sk to block multiples")


def flash_attention_plain(
    q: torch.Tensor,  # (B, H, Sq, hd)
    k: torch.Tensor,  # (B, KV, Sk, hd)
    v: torch.Tensor,  # (B, KV, Sk, hd)
    q_positions: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Plain PyTorch version: the kernel's blocked online softmax, in fp32."""
    _check(q, k, v, block_q, block_k)
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    if sm_scale is None:
        sm_scale = hd ** -0.5
    if q_positions is None:
        q_positions = torch.arange(sq, dtype=torch.int32, device=q.device)
    q_positions = q_positions.to(torch.int32)
    n_kv = sk // block_k
    qf = q.float().reshape(b, kv, g, sq, hd) * sm_scale
    kf, vf = k.float(), v.float()
    out = torch.empty((b, kv, g, sq, hd), dtype=torch.float32, device=q.device)
    for i in range(sq // block_q):
        rows = slice(i * block_q, (i + 1) * block_q)
        qb = qf[:, :, :, rows]
        pos = q_positions[rows][:, None]  # (bq, 1)
        upper = min(int(pos.max()) // block_k + 1, n_kv) if causal else n_kv
        m = torch.full((b, kv, g, block_q, 1), _NEG, device=q.device)
        l = torch.zeros((b, kv, g, block_q, 1), device=q.device)
        acc = torch.zeros((b, kv, g, block_q, hd), device=q.device)
        for j in range(max(upper, 0)):
            cols = slice(j * block_k, (j + 1) * block_k)
            s = torch.einsum("bkgqd,bkcd->bkgqc", qb, kf[:, :, cols])
            if causal:
                k_pos = j * block_k + torch.arange(block_k, device=q.device)[None, :]
                mask = k_pos <= pos
                s = torch.where(mask, s, torch.full_like(s, _NEG))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            if causal:
                p = p * mask.float()
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bkgqc,bkcd->bkgqd", p, vf[:, :, cols])
            m = m_new
        out[:, :, :, rows] = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, h, sq, hd).to(q.dtype)


def _work(q, k, v, q_positions=None, *, causal=True, **_):
    """K2's work for ``op_stats``: q.k and p.v over the (query, key) pairs
    it computes (causal: key <= query position, positions 0 .. Sq - 1), six
    bf16 tensor-core passes of them for bf16 k/v (two CUDA-core passes for
    float32), q, k, v in and the output out once (its bound in ``PERF.md``)."""
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    n = min(sq, sk)
    pairs = b * h * (n * (n + 1) // 2 + (sq - n) * sk if causal else sq * sk)
    dots = 2.0 * 2 * hd * pairs
    passes = 3 if k.dtype == torch.bfloat16 else 1
    n_bytes = 2 * q.numel() * q.element_size() + (k.numel() + v.numel()) * k.element_size()
    return dots, passes * dots, n_bytes


@work.kernel("flash_attention", _work)
def flash_attention(
    q: torch.Tensor,  # (B, H, Sq, hd)
    k: torch.Tensor,  # (B, KV, Sk, hd)  KV divides H (GQA)
    v: torch.Tensor,  # (B, KV, Sk, hd)
    q_positions: Optional[torch.Tensor] = None,  # (Sq,) absolute; default arange
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Flash attention forward. CPU tensors take the plain version; CUDA
    tensors must be contiguous, float32 or bfloat16 (k and v of one dtype),
    with head_dim <= 128, and launch the kernel. The output has q's dtype.

    Forward only, on every device: with grad mode on and any of q, k, v
    requiring grad it raises ``RuntimeError``, since the kernel's output
    would reach autograd as a constant and cut every attention gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward-only, as the JAX package's flash path is (there is no "
            "backward kernel); train with attn_impl=\"blocked\", or run the forward under "
            "torch.no_grad()"
        )
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(
            q, k, v, q_positions, causal=causal, sm_scale=sm_scale,
            block_q=block_q, block_k=block_k,
        )
    _check(q, k, v, block_q, block_k)
    return _launch(q, k, v, q_positions, causal, sm_scale)


@functools.lru_cache(maxsize=None)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    """The default query positions ``0 .. n - 1`` on ``device``, made once per
    (n, device): a call makes no launch for them."""
    with torch.inference_mode(False):  # usable outside inference mode too
        return torch.arange(n, dtype=torch.int32, device=device)


def _lib():
    fn = build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, q_positions, causal, sm_scale):
    global launches
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(
            f"flash_attention: q/k/v on {q.device}, {k.device}, {v.device}; the "
            f"kernel takes tensors on one CUDA device (CPU tensors take the plain version)"
        )
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(
            f"flash_attention: the kernel takes float32 or bfloat16 q, and k/v of one "
            f"such dtype, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if hd > _KERNEL_HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention: head_dim {hd} > {_KERNEL_HEAD_DIMS[-1]}")
    if sm_scale is None:
        sm_scale = hd ** -0.5
    if q_positions is None:
        q_positions = _arange(sq, dev)
    q_positions = q_positions.to(device=dev, dtype=torch.int32).contiguous()
    if q_positions.shape != (sq,):
        raise ValueError(f"flash_attention: q_positions {tuple(q_positions.shape)} != ({sq},)")
    hd_k = next(d for d in _KERNEL_HEAD_DIMS if d >= hd)
    if hd_k != hd:  # zero dims add nothing to q.k and come out as zero columns
        q, k, v = (F.pad(t, (0, hd_k - hd)) for t in (q, k, v))
    out = torch.empty((b, h, sq, hd_k), dtype=q.dtype, device=dev)
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
        b, h, kv, sq, sk, hd_k, _DTYPES[q.dtype], _DTYPES[k.dtype], sm_scale, int(causal),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    launches += 1
    return out if hd_k == hd else out[..., :hd].contiguous()
