"""Weights from the JAX package into the PyTorch port.

``params_from_jax`` takes the nested dict of numpy arrays that
``jax.tree_util.tree_map(np.asarray, params)`` yields from the JAX
``init_transformer`` and returns the port's params: same names, shapes,
layouts and dtypes. It never imports jax: bfloat16 arrays arrive as numpy
arrays of the ``bfloat16`` extension dtype and are reinterpreted bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

__all__ = ["params_from_jax"]


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # owned and writable
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(np_params: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Port params on ``device`` from a nested dict of numpy arrays."""
    device = resolve_device(device)
    expected = torch.empty((), dtype=getattr(torch, cfg.param_dtype))

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        t = _tensor(np.asarray(tree), device)
        if t.is_floating_point() and t.dtype != expected.dtype:
            raise ValueError(f"param dtype {t.dtype} != cfg.param_dtype {cfg.param_dtype}")
        return t

    return walk(np_params)
