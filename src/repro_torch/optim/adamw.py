"""AdamW on trees of tensors (counterpart of ``repro.optim.adamw``).

A function on dicts of tensors, as the JAX package writes it, and not
``torch.optim.AdamW``, which clips, decays and bias-corrects otherwise:
global-norm clipping over all leaves in JAX's leaf order, float32 moments,
bias correction by ``1 - b ** count``, decoupled weight decay inside the
step. The update is functional: it returns new params and state."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.device import divisor
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamWState", "adamw_init", "adamw_update"]


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return AdamWState(
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _promoted(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``g * scale`` in the type JAX promotes them to: a 0-d float32 array
    is not weakly typed there, so bf16 grads become float32."""
    return g.to(torch.promote_types(g.dtype, scale.dtype)) * scale


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    params,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
):
    """One step: ``(new_params, new_state, {"grad_norm": ...})``."""
    count = state.count + 1
    if grad_clip is not None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
        scale = torch.clamp(divisor(grad_clip, gnorm) / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = tree_map(lambda g: _promoted(g, scale), grads)
    else:
        gnorm = torch.zeros((), device=count.device)

    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state.m, grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()), state.v, grads)
    c1 = 1 - b1 ** count.float()
    c2 = 1 - b2 ** count.float()

    def upd(p, m_, v_):
        step = (m_ / c1) / (torch.sqrt(v_ / c2) + eps)
        return (p.float() - lr * (step + weight_decay * p.float())).to(p.dtype)

    new_params = tree_map(upd, params, m, v)
    return new_params, AdamWState(m=m, v=v, count=count), {"grad_norm": gnorm}
