"""Int8 gradient compression for a data-parallel all-reduce (counterpart of
``repro.optim.grad_compression``).

Each gradient leaf is quantized to int8 against one scale shared by every
rank (the ``pmax`` of their largest magnitudes), the int8 payloads are
summed in int32 and dequantized, and an error-feedback buffer carries each
rank's rounding residual into its next step, so the compression stays
unbiased over steps.

One device holds every rank here, as ``fabric/collectives.py`` holds every
chip: :func:`compressed_psum_tree` takes the per-rank gradient trees as a
list and replays the JAX ``shard_map`` collectives as explicit reductions,
the int32 sum in rank order. As in the JAX package, the train step does not
call it (``launch/train.py`` has one rank).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.device import divisor
from repro_torch.tree import tree_leaves, tree_map, unflatten_like

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum_tree", "init_error_feedback"]


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(absmax / divisor(127.0, absmax), min=1e-12)


def _codes(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def quantize_int8(g: torch.Tensor):
    """``(q int8, scale)``: ``g`` over one symmetric scale, its largest
    magnitude / 127 (at least 1e-12), rounded half to even."""
    scale = torch.clamp(torch.amax(torch.abs(g)), min=1e-12) / divisor(127.0, g, g.dtype)
    return _codes(g, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_feedback(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compressed_psum_tree(grads: Sequence[Any], error_feedback: Optional[Sequence[Any]] = None):
    """The ranks' mean gradient through the int8 wire format.

    ``grads`` is one gradient tree per rank, ``error_feedback`` one residual
    tree per rank (or None). Returns ``(mean, new_error_feedback)``: the
    tree every rank receives (the int32 sum of the ranks' codes, in rank
    order, times the shared scale, over the rank count) and the list of the
    ranks' new residual trees."""
    n = len(grads)
    flat_g = [tree_leaves(g) for g in grads]
    flat_e = [tree_leaves(e) for e in error_feedback] if error_feedback is not None else [None] * n
    means, resids = [], [[] for _ in range(n)]
    for i in range(len(flat_g[0])):
        g32 = [
            flat_g[r][i].to(torch.float32) + (flat_e[r][i] if flat_e[r] is not None else 0.0) for r in range(n)
        ]
        # shared scale so the int8 payloads are summable across ranks
        scale = _scale(torch.stack([torch.amax(torch.abs(g)) for g in g32]).amax())
        tot = torch.zeros(g32[0].shape, dtype=torch.int32, device=g32[0].device)
        for r, g in enumerate(g32):
            q = _codes(g, scale)
            resids[r].append(g - q.to(torch.float32) * scale)
            tot = tot + q.to(torch.int32)
        means.append(tot.to(torch.float32) * scale / divisor(n, tot))
    return unflatten_like(grads[0], means), [unflatten_like(grads[0], res) for res in resids]
