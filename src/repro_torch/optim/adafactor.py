"""Adafactor on trees of tensors (counterpart of ``repro.optim.adafactor``):
factored second moments, no momentum, O(rows + cols) state for every leaf
of two or more dims, float32 state."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.device import divisor
from repro_torch.tree import tree_leaves, tree_map, unflatten_like

__all__ = ["AdafactorState", "adafactor_init", "adafactor_update"]


class AdafactorState(NamedTuple):
    v_row: Any  # factored stats for >= 2-D leaves ((1,) zeros otherwise)
    v_col: Any
    v_full: Any  # full stats for < 2-D leaves
    count: torch.Tensor


def _factored(p) -> bool:
    return p.dim() >= 2


def adafactor_init(params) -> AdafactorState:
    def zeros(shape, p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vr(p):
        return zeros(p.shape[:-1] if _factored(p) else (1,), p)

    def vc(p):
        return zeros(p.shape[:-2] + p.shape[-1:] if _factored(p) else (1,), p)

    def vf(p):
        return zeros((1,) if _factored(p) else p.shape, p)

    return AdafactorState(
        v_row=tree_map(vr, params),
        v_col=tree_map(vc, params),
        v_full=tree_map(vf, params),
        count=torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
    )


@torch.no_grad()
def adafactor_update(
    grads,
    state: AdafactorState,
    params,
    lr,
    decay: float = 0.99,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
):
    """One step: ``(new_params, new_state, {"grad_norm": 0})``."""
    count = state.count + 1

    def upd(p, g, vr, vc, vf):
        g = g.float()
        g2 = torch.square(g) + eps
        if _factored(p):
            vr = decay * vr + (1 - decay) * g2.mean(dim=-1)
            vc = decay * vc + (1 - decay) * g2.mean(dim=-2)
            # v_hat = (vr (x) vc) / mean(vr)  (Shazeer & Stern, 2018)
            denom = (
                torch.sqrt(vr)[..., None]
                * torch.sqrt(vc)[..., None, :]
                * torch.rsqrt(torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps))[..., None]
            )
            u = g / torch.clamp(denom, min=eps)
        else:
            vf = decay * vf + (1 - decay) * g2
            u = g * torch.rsqrt(vf)
        rms_u = torch.sqrt(torch.mean(torch.square(u)) + eps)
        u = u / torch.clamp(rms_u / divisor(clip_threshold, rms_u), min=1.0)
        newp = p.float() - lr * (u + weight_decay * p.float())
        return newp.to(p.dtype), vr, vc, vf

    outs = [upd(*leaves) for leaves in zip(*map(tree_leaves, (params, grads, state.v_row, state.v_col, state.v_full)))]
    new = [unflatten_like(params, [o[i] for o in outs]) for i in range(4)]
    grad_norm = torch.zeros((), device=count.device)
    return new[0], AdafactorState(v_row=new[1], v_col=new[2], v_full=new[3], count=count), {"grad_norm": grad_norm}
