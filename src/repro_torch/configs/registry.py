"""Architecture registry: --arch <id> lookup + shape-specific overrides
(a copy of ``repro.configs.registry`` for the PyTorch port)."""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    command_r_plus_104b,
    llama3_405b,
    mamba2_130m,
    moonshot_v1_16b_a3b,
    musicgen_medium,
    pixtral_12b,
    qwen2_5_32b,
    qwen3_moe_30b_a3b,
    smollm_135m,
    zamba2_7b,
)
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import SHAPES, ShapeConfig

ARCHS: dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (
        pixtral_12b,
        musicgen_medium,
        zamba2_7b,
        qwen3_moe_30b_a3b,
        moonshot_v1_16b_a3b,
        mamba2_130m,
        command_r_plus_104b,
        smollm_135m,
        qwen2_5_32b,
        llama3_405b,
    )
}

__all__ = ["ARCHS", "get_config", "for_shape"]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def for_shape(cfg: ModelConfig, shape: ShapeConfig | str) -> ModelConfig:
    """Shape-specific config adjustments, the same as the JAX package's."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    over: dict = {}
    if shape.name == "long_500k" and cfg.family == "hybrid":
        # cap the shared attention span so the hybrid stays sub-quadratic
        over["sliding_window"] = 4096
    if shape.kind == "prefill":
        over["attn_chunk"] = 2048
        # the fused flash-attention prefill stays opt-in (attn_impl="flash"),
        # as in the JAX package's registry
    if shape.kind == "decode" and cfg.n_heads and not _legacy():
        # perf iteration C2: int8 KV cache + integer score/PV dots for serving
        over["kv_quant_int8"] = True
    return dataclasses.replace(cfg, **over) if over else cfg


def _legacy() -> bool:
    import os

    return os.environ.get("REPRO_LEGACY_NORM", "0") == "1"
