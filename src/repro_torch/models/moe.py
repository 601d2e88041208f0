"""Mixture-of-Experts FFN of the PyTorch port (counterpart of
``repro.models.moe``): top-k routing with capacity-bucketed dispatch
(``moe_ffn``), or every expert on every token, masked by the routing weights
(``moe_ffn_dense``).

Routing follows ``jax.lax.top_k``: where probabilities tie, the lower expert
index comes first. A stable descending sort gives that order; ``torch.topk``
does not promise it, and bf16 router logits tie often. The order decides
which tied expert is taken at the k-th place and, in ``moe_ffn``, which
choices win a capacity slot.

With a CiM config, ``moe_ffn`` runs each expert's three projections through
``core.cim_linear.cim_matmul`` one expert at a time, so that each expert
quantizes its own buffer with its own scales, as the JAX package's ``vmap``
over experts does (an expert that receives no token has an all-zero buffer,
whose scale falls back to 1). ``moe_ffn_dense`` computes its experts with
plain products, as the JAX package does. The plain products stay
``torch.einsum``: the JAX package computes them outside any Pallas kernel.
One device: the JAX package's sharding constraints have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _fan_normal, pdtype

__all__ = ["init_moe", "expert_capacity", "route", "moe_ffn", "moe_ffn_dense"]


def init_moe(gen: torch.Generator, cfg: ModelConfig, n_layers: int):
    """Random init from ``gen`` (the JAX package's names, shapes and dtypes:
    every leaf float32, see ``layers._fan_normal``)."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    dt = pdtype(cfg)
    return {
        "router": _fan_normal(gen, (n_layers, d, e), d, torch.float32),
        "w_gate": _fan_normal(gen, (n_layers, e, d, f), d, dt),
        "w_up": _fan_normal(gen, (n_layers, e, d, f), d, dt),
        "w_down": _fan_normal(gen, (n_layers, e, f, d), f, dt),
    }


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(np.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to 8


def route(router: torch.Tensor, xt: torch.Tensor, k: int):
    """Router of tokens ``xt`` (T, D): returns ``(probs (T, E) float32,
    gate (T, k) normalized, idx (T, k))``, the top ``k`` in descending order
    with ties taken lower index first, as ``jax.lax.top_k`` takes them."""
    logits = (xt @ router.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, e: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum(first-choice share * mean prob)."""
    frac_tokens = F.one_hot(idx[:, 0], e).float().mean(0)
    return e * torch.sum(frac_tokens * probs.mean(0))


def _dispatch(idx: torch.Tensor, e: int, cap: int):
    """Capacity slots of the (k·T,) choices, choice-major so first choices
    win: ``(idx_f, slot, keep)``; an overflowed choice goes to slot ``cap``."""
    idx_f = idx.T.reshape(-1)
    onehot = F.one_hot(idx_f, e).float()  # (kT, E)
    pos_f = torch.cumsum(onehot, dim=0) - 1.0  # running count per expert
    pos_f = torch.gather(pos_f, 1, idx_f[:, None])[:, 0]
    keep = pos_f < cap
    slot = torch.where(keep, pos_f, torch.full_like(pos_f, cap)).to(torch.int64)
    return idx_f, slot, keep


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Capacity-bucketed MoE: x (B, S, D) -> (y (B, S, D), aux_loss scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    cap = expert_capacity(t, cfg)
    xt = x.reshape(t, d)
    probs, gate, idx = route(p["router"], xt, k)
    idx_f, slot, keep = _dispatch(idx, e, cap)

    # dispatch: scatter tokens into (E, C+1, D); slot `cap` is the trash row
    buf = torch.zeros((e, cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf.index_put_((idx_f, slot), xt.repeat(k, 1), accumulate=True)
    buf = buf[:, :cap, :]

    cim = cfg.cim
    if cim is not None and cim.mode != "exact":
        from repro_torch.core.cim_linear import cim_matmul

        bf32 = buf.float()
        out = torch.empty_like(bf32)
        for j in range(e):  # per expert: its own activation and weight scales
            h = F.silu(cim_matmul(bf32[j], p["w_gate"][j].float(), cim)) * cim_matmul(
                bf32[j], p["w_up"][j].float(), cim
            )
            out[j] = cim_matmul(h, p["w_down"][j].float(), cim)
        out = out.to(buf.dtype)
    else:
        h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w_gate"].to(buf.dtype))) * torch.einsum(
            "ecd,edf->ecf", buf, p["w_up"].to(buf.dtype)
        )
        out = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(h.dtype))  # (E, C, D)

    # combine: gather back, apply gates, drop overflowed
    out_pad = F.pad(out, (0, 0, 0, 1))  # restore the trash row
    y_f = out_pad[idx_f, slot]  # (kT, D)
    gate_f = gate.T.reshape(-1) * keep.float()
    y = (y_f.float() * gate_f[:, None]).reshape(k, t, d).sum(0)
    return y.to(x.dtype).reshape(b, s, d), _aux_loss(probs, idx, e)


def moe_ffn_dense(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Every expert on every token, weighted by the (T, E) routing weights
    (zero off the top k): no dispatch and no capacity drops. The weights are
    cast to the compute dtype and folded in before the down projection, so
    the (E, T, D) intermediate never exists."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    probs, gate, idx = route(p["router"], xt, k)
    w_te = torch.zeros((t, e), dtype=torch.float32, device=x.device)
    w_te.scatter_add_(1, idx, gate)
    w_te = w_te.to(x.dtype)

    hg = torch.einsum("td,edf->etf", xt, p["w_gate"].to(xt.dtype))
    hu = torch.einsum("td,edf->etf", xt, p["w_up"].to(xt.dtype))
    hw = F.silu(hg) * hu * w_te.T[:, :, None]
    y = torch.einsum("etf,efd->td", hw, p["w_down"].to(hw.dtype))
    return y.to(x.dtype).reshape(b, s, d), _aux_loss(probs, idx, e)
