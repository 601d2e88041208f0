"""Weights from the JAX package into the PyTorch port.

``params_from_jax`` takes the nested dict of numpy arrays that
``jax.tree_util.tree_map(np.asarray, params)`` yields from a JAX model's
``init`` and returns the port's params: same names, shapes, layouts and
dtypes. It never imports jax: bfloat16 arrays arrive as numpy arrays of the
``bfloat16`` extension dtype and are reinterpreted bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

__all__ = ["params_from_jax"]

# Leaves the JAX init gives float32 whatever cfg.param_dtype is: the MoE
# router and Mamba2's A_log, D and dt_bias by design, and every weight it
# draws in param_dtype and scales by a numpy float64 ``1 / np.sqrt(fan)``
# (JAX promotes a bfloat16 array times a numpy float64 to float32). The
# embedding table (scaled by a Python float), the norms and the biases keep
# param_dtype.
FLOAT32_LEAVES = frozenset({
    "router", "A_log", "D", "dt_bias",
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "unembed",
    "in_z", "in_x", "in_b", "in_c", "in_dt", "conv_x", "conv_b", "conv_c", "out_proj",
})


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # owned and writable
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(np_params: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Port params on ``device`` from a nested dict of numpy arrays. Each
    floating leaf must have the dtype the JAX init gives it: float32 for the
    leaves in ``FLOAT32_LEAVES``, ``cfg.param_dtype`` for the rest."""
    device = resolve_device(device)
    pdt = getattr(torch, cfg.param_dtype)

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        t = _tensor(np.asarray(tree), device)
        want = torch.float32 if name in FLOAT32_LEAVES else pdt
        if t.is_floating_point() and t.dtype != want:
            raise ValueError(f"param {name!r} has dtype {t.dtype}; the JAX init gives it {want}")
        return t

    return walk(np_params, None)
