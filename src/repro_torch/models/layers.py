"""Shared neural-net layers of the PyTorch port (counterpart of
``repro.models.layers``), as plain functions on tensors.

Conventions, as in the JAX package:
  * params are nested dicts of tensors; layer-stacked params carry a leading
    ``L`` dim, and the transformer walks it with a Python loop.
  * every matmul goes through :func:`dense`, which routes to the CiM-quantized
    op when the config enables the paper's technique.
  * prefill attention is blocked (online softmax over KV chunks) or, with
    ``attn_impl="flash"``, the flash-attention CUDA kernel, which is
    forward-only (it raises under autograd, so training takes the blocked
    path); decode (Sq == 1) uses direct attention over the cache.
  * the training loss is :func:`chunked_xent`, which never materializes the
    (B, S, V) logits.

One device: the JAX package's activation sharding constraints have no
counterpart here. The KV cache is updated in place (the JAX functions return
a new cache); the functions return the same dict, so callers read it alike.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cim_linear import CiMConfig, cim_matmul
from repro_torch.obs import trace as obs_trace

_NEG = -1e30

__all__ = [
    "dense",
    "rms_norm",
    "apply_rope",
    "init_attention",
    "attention",
    "decode_attention",
    "make_attn_cache",
    "init_mlp",
    "mlp",
    "init_embedding",
    "embed",
    "unembed_weight",
    "logits_step",
    "chunked_xent",
    "layer_slice",
]

def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def layer_slice(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views, so cache writes land in place)."""
    return {k: (layer_slice(v, i) if isinstance(v, dict) else v[i]) for k, v in tree.items()}


def _normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * scale).to(dtype)


def _fan_normal(gen: torch.Generator, shape, fan: int, dtype: torch.dtype) -> torch.Tensor:
    """A ``dtype`` normal draw divided by sqrt(fan), in float32 whatever
    ``dtype`` is: the JAX package scales its draws by a numpy float64
    scalar, which JAX does not treat as weakly typed, so its fan-scaled
    weights are float32 even where ``param_dtype`` is bfloat16."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    x.copy_(x.to(dtype))
    return x.div_(float(np.sqrt(fan)))


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def dense(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    cim: Optional[CiMConfig] = None,
):
    """Linear layer; routes through the CiM pipeline when enabled."""
    if cim is not None and cim.mode != "exact":
        y = cim_matmul(x, w.float(), cim).to(x.dtype)
    else:
        y = x @ w.to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm: fp32 statistics, tensors in x's dtype (the JAX package's
    default, non-legacy path)."""
    xf = x.float()
    var = (torch.einsum("...d,...d->...", xf, xf) / x.shape[-1])[..., None]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale.to(x.dtype))


def _rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(
    x: torch.Tensor,  # (B, S, n, head_dim)
    positions: torch.Tensor,  # (S,) int
    theta: float,
) -> torch.Tensor:
    hd = x.shape[-1]
    freqs = torch.tensor(_rope_freqs(hd, theta), dtype=torch.float32, device=x.device)
    ang = positions.float()[..., None] * freqs  # (S, hd/2)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, blocked or flash prefill + cached decode)
# ---------------------------------------------------------------------------


def _flash_prefill(q, k, v):
    """Flash-attention prefill on the CUDA kernel (the counterpart of the JAX
    package's ``_flash_sharded`` on one device). q (B, S, KV, G, hd) arrives
    pre-scaled in float32, so ``sm_scale=1``; k/v keep the compute dtype."""
    from repro_torch.kernels.flash_attention import flash_attention

    b, s, kv, g, hd = q.shape
    qh = q.reshape(b, s, kv * g, hd).transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).contiguous()
    vh = v.transpose(1, 2).contiguous()
    out = flash_attention(qh, kh, vh, causal=True, sm_scale=1.0)
    return out.transpose(1, 2).reshape(b, s, kv, g, hd)


def init_attention(gen: torch.Generator, cfg: ModelConfig, n_layers: int):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = pdtype(cfg)
    p = {
        "wq": _fan_normal(gen, (n_layers, d, h * hd), d, dt),
        "wk": _fan_normal(gen, (n_layers, d, kv * hd), d, dt),
        "wv": _fan_normal(gen, (n_layers, d, kv * hd), d, dt),
        "wo": _fan_normal(gen, (n_layers, h * hd, d), h * hd, dt),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros((n_layers, width), dtype=dt, device=gen.device)
    return p


def _blocked_sdpa(
    q: torch.Tensor,  # (B, Sq, K, G, hd) float32, scaled
    k: torch.Tensor,  # (B, Sk, K, hd)
    v: torch.Tensor,  # (B, Sk, K, hd)
    q_pos: torch.Tensor,  # (Sq,) absolute positions of queries
    k_pos: torch.Tensor,  # (Sk,) absolute positions of keys
    chunk: int,
    window: Optional[int],
) -> torch.Tensor:
    """Online softmax over KV chunks in fp32 (the JAX package's scores and
    probabilities take the dtype of q, which is float32 there too)."""
    b, sq, kh, g, hd = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    pad = (-sk) % chunk
    if pad:  # pad keys; sentinel positions never pass the causal mask
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.cat([k_pos, torch.full((pad,), 1 << 30, dtype=k_pos.dtype, device=k_pos.device)])
        sk += pad
    m = torch.full((b, sq, kh, g), _NEG, device=q.device)
    l = torch.zeros((b, sq, kh, g), device=q.device)
    acc = torch.zeros((b, sq, kh, g, hd), device=q.device)
    for c in range(sk // chunk):
        cols = slice(c * chunk, (c + 1) * chunk)
        kci, vci, pci = k[:, cols], v[:, cols], k_pos[cols]
        s = torch.einsum("bqkgd,bckd->bqkgc", q, kci.float())
        mask = pci[None, None, None, None, :] <= q_pos[None, :, None, None, None]
        if window is not None:
            mask &= pci[None, None, None, None, :] > (q_pos[None, :, None, None, None] - window)
        s = torch.where(mask, s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * mask.float()
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vci.float())
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def _quantize_kv(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 KV-cache codes of x (B, S, KV, hd) with per-kv-head scales (KV,)."""
    return torch.clamp(torch.round(x.float() / scale[None, None, :, None]), -127, 127).to(torch.int8)


def attention(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    positions: torch.Tensor,  # (S,)
    cache: Optional[dict] = None,  # one layer's cache, filled in place
):
    """Full-sequence (training or prefill) GQA attention. Returns (out,
    cache); without a cache (training) nothing is written."""
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    cim = cfg.cim

    q = dense(x, p["wq"], p.get("bq"), cim).reshape(b, s, h, hd)
    k = dense(x, p["wk"], p.get("bk"), cim).reshape(b, s, kv, hd)
    v = dense(x, p["wv"], p.get("bv"), cim).reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # float32, as the JAX package's promotion of q by a numpy scalar gives
    q = q.reshape(b, s, kv, g, hd).float() / np.sqrt(hd)

    if cfg.attn_impl == "flash" and cfg.sliding_window is None:
        out = _flash_prefill(q, k, v)
    else:
        out = _blocked_sdpa(q, k, v, positions, positions, cfg.attn_chunk, cfg.sliding_window)
    out = out.to(x.dtype).reshape(b, s, h * hd)
    y = dense(out, p["wo"], None, cim)
    if cache is not None:
        sc = cache["k"].shape[1]
        if cache["k"].dtype == torch.int8:
            # int8 KV cache: per-kv-head symmetric scales computed at prefill
            k_scale = torch.clamp(torch.amax(k.float().abs(), dim=(0, 1, 3)) / 127.0, min=1e-8)
            v_scale = torch.clamp(torch.amax(v.float().abs(), dim=(0, 1, 3)) / 127.0, min=1e-8)
            k, v = _quantize_kv(k, k_scale), _quantize_kv(v, v_scale)
            cache["k_scale"].copy_(k_scale)
            cache["v_scale"].copy_(v_scale)
        if s <= sc:  # prefix fits: write at the front
            cache["k"][:, :s] = k.to(cache["k"].dtype)
            cache["v"][:, :s] = v.to(cache["v"].dtype)
            cache["pos"][:s] = positions.to(torch.int32)
        else:  # window cache: keep last sc keys, ring-rotated (slot = pos % sc)
            shift = (s - sc) % sc
            cache["k"].copy_(torch.roll(k[:, -sc:].to(cache["k"].dtype), shift, dims=1))
            cache["v"].copy_(torch.roll(v[:, -sc:].to(cache["v"].dtype), shift, dims=1))
            cache["pos"].copy_(torch.roll(positions[-sc:].to(torch.int32), shift))
    return y, cache


def decode_attention(
    p: dict,
    x: torch.Tensor,  # (B, 1, D)
    cfg: ModelConfig,
    pos: int,  # current absolute position
    cache: dict,  # one layer's {"k": (B, Sc, KV, hd), "v": ..., "pos": (Sc,)}
):
    """Single-token cached decode; writes this token into the cache in place."""
    b, _, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    cim = cfg.cim
    pos = int(pos)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=x.device)

    q = dense(x, p["wq"], p.get("bq"), cim).reshape(b, 1, h, hd)
    k = dense(x, p["wk"], p.get("bk"), cim).reshape(b, 1, kv, hd)
    v = dense(x, p["wv"], p.get("bv"), cim).reshape(b, 1, kv, hd)
    q = apply_rope(q, pos_t, cfg.rope_theta)
    k = apply_rope(k, pos_t, cfg.rope_theta)

    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slot = pos % ck.shape[1]  # ring buffer when window-capped, linear otherwise
    int8_kv = ck.dtype == torch.int8
    if int8_kv:
        ks, vs = cache["k_scale"], cache["v_scale"]  # (KV,)
        ck[:, slot : slot + 1] = _quantize_kv(k, torch.clamp(ks, min=1e-8))
        cv[:, slot : slot + 1] = _quantize_kv(v, torch.clamp(vs, min=1e-8))
    else:
        ck[:, slot : slot + 1] = k.to(ck.dtype)
        cv[:, slot : slot + 1] = v.to(cv.dtype)
    cpos[slot] = pos

    valid = (cpos <= pos) & (cpos >= 0)
    if cfg.sliding_window is not None:
        valid &= cpos > pos - cfg.sliding_window
    vmask = valid[None, None, None, None, :]

    qh = q.reshape(b, 1, kv, g, hd).float() / np.sqrt(hd)
    if int8_kv:
        # integer score dot: q quantized per kv-head against the int8 cache;
        # int8 x int8 products summed exactly (in float64 here: every partial
        # sum is an integer below 2^53)
        sq = torch.clamp(torch.amax(qh.abs(), dim=(0, 1, 3, 4)) / 127.0, min=1e-8)  # (KV,)
        q_i8 = torch.clamp(torch.round(qh / sq[None, None, :, None, None]), -127, 127)
        s_i = torch.einsum("bqkgd,bckd->bqkgc", q_i8.double(), ck.double())
        s = s_i.float() * (sq * ks)[None, None, :, None, None]
        s = torch.where(vmask, s, torch.full_like(s, _NEG))
        m = s.amax(dim=-1, keepdim=True)
        pattn = torch.exp(s - m) * vmask.float()
        # probabilities quantized to s8 so the V read stays s8
        p_i8 = torch.clamp(torch.round(pattn * 127.0), 0, 127)
        o_i = torch.einsum("bqkgc,bckd->bqkgd", p_i8.double(), cv.double())
        out = o_i.float() * (vs / 127.0)[None, None, :, None, None]
        out = out / torch.clamp(pattn.sum(-1)[..., None], min=1e-30)
    else:
        s = torch.einsum("bqkgd,bckd->bqkgc", qh, ck.float())
        s = torch.where(vmask, s, torch.full_like(s, _NEG))
        m = s.amax(dim=-1, keepdim=True)
        pattn = torch.exp(s - m) * vmask.float()
        out = torch.einsum("bqkgc,bckd->bqkgd", pattn, cv.float())
        out = out / torch.clamp(pattn.sum(-1)[..., None], min=1e-30)
    out = out.to(x.dtype).reshape(b, 1, h * hd)
    y = dense(out, p["wo"], None, cim)
    return y, cache


def make_attn_cache(cfg: ModelConfig, batch: int, seq_len: int, n_layers: int, device):
    """Preallocated KV cache (seq capped to the sliding window if set).

    ``cfg.kv_quant_int8`` stores K/V as int8 with per-(layer, kv-head)
    scales."""
    sc = seq_len if cfg.sliding_window is None else min(seq_len, cfg.sliding_window)
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    dt = torch.int8 if cfg.kv_quant_int8 else cdtype(cfg)
    cache = {
        "k": torch.zeros((n_layers, batch, sc, kv, hd), dtype=dt, device=device),
        "v": torch.zeros((n_layers, batch, sc, kv, hd), dtype=dt, device=device),
        "pos": torch.full((n_layers, sc), -1, dtype=torch.int32, device=device),
    }
    if cfg.kv_quant_int8:
        cache["k_scale"] = torch.full((n_layers, kv), 1e-2, dtype=torch.float32, device=device)
        cache["v_scale"] = torch.full((n_layers, kv), 1e-2, dtype=torch.float32, device=device)
    return cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig, n_layers: int, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = pdtype(cfg)
    return {
        "w_gate": _fan_normal(gen, (n_layers, d, f), d, dt),
        "w_up": _fan_normal(gen, (n_layers, d, f), d, dt),
        "w_down": _fan_normal(gen, (n_layers, f, d), f, dt),
    }


def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig):
    cim = cfg.cim
    gate = dense(x, p["w_gate"], None, cim)
    up = dense(x, p["w_up"], None, cim)
    return dense(F.silu(gate) * up, p["w_down"], None, cim)


# ---------------------------------------------------------------------------
# Embedding, chunked softmax cross-entropy, logits
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, cfg: ModelConfig):
    v, d = cfg.padded_vocab, cfg.d_model
    dt = pdtype(cfg)
    p = {"tok": _normal(gen, (v, d), 0.02, dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = _fan_normal(gen, (d, v), d, dt)
    return p


def embed(p: dict, tokens_or_x: torch.Tensor, cfg: ModelConfig):
    if cfg.input_kind == "embeddings":
        return tokens_or_x.to(cdtype(cfg))
    return p["tok"][tokens_or_x.long()].to(cdtype(cfg))


def unembed_weight(p: dict, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return p["tok"].T
    return p["unembed"]


def _vocab_mask(cfg: ModelConfig, device) -> torch.Tensor:
    return (torch.arange(cfg.padded_vocab, device=device) < cfg.vocab).float()


def _chunk_loss(hi, li, w, vmask):
    """(summed xent, count of labels >= 0) of one sequence chunk."""
    logits = (hi @ w.to(hi.dtype)).float()
    logits = logits + (vmask - 1.0) * 1e9  # mask padded vocab
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, torch.clamp(li, min=0)[..., None].long())[..., 0]
    valid = (li >= 0).float()
    return ((lse - picked) * valid).sum(), valid.sum()


def chunked_xent(
    p: dict,
    h: torch.Tensor,  # (B, S, D) final hidden states
    labels: torch.Tensor,  # (B, S) int, -1 = ignore
    cfg: ModelConfig,
) -> torch.Tensor:
    """Mean next-token cross-entropy without materializing (B, S, V) logits.

    Walks the sequence in ``cfg.loss_chunk`` slices; each slice's logits are
    recomputed in the backward pass (``torch.utils.checkpoint``, as the JAX
    package's ``jax.checkpoint``), and the sums are added in slice order."""
    w = unembed_weight(p, cfg)
    s = h.shape[1]
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of loss_chunk {c}: pad it")
    vmask = _vocab_mask(cfg, h.device)
    tot = torch.zeros((), device=h.device)
    cnt = torch.zeros((), device=h.device)
    for i in range(s // c):
        cols = slice(i * c, (i + 1) * c)
        l, v = checkpoint(_chunk_loss, h[:, cols], labels[:, cols], w, vmask, use_reentrant=False)
        tot, cnt = tot + l, cnt + v
    return tot / torch.clamp(cnt, min=1.0)


def logits_step(p: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Decode-step logits (B, 1, V) in fp32, padded vocab masked to -1e9
    (a ``layer.unembed`` span under ``repro_torch.obs`` tracing)."""
    with obs_trace.span("layer.unembed"):
        w = unembed_weight(p, cfg)
        logits = (h @ w.to(h.dtype)).float()
        return logits + (_vocab_mask(cfg, h.device) - 1.0) * 1e9
