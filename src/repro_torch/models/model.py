"""Unified model API of the PyTorch port: ``build_model(cfg, device)`` ->
init / make_cache / prefill / decode_step (counterpart of
``repro.models.model``). Only the dense family is ported so far."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer

__all__ = ["Model", "build_model"]


class Model(NamedTuple):
    config: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Any]  # (generator on device) -> params
    make_cache: Callable[..., Any]  # (batch, seq_len) -> cache
    prefill: Callable[..., Any]  # (params, inputs, cache) -> (logits_last, cache)
    decode_step: Callable[..., Any]  # (params, token, pos, cache) -> (logits, cache)


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (CUDA unless the caller asks for
    the CPU; raises when CUDA is asked for and absent)."""
    device = resolve_device(device)
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet (ROADMAP.md, port queue A)"
        )

    def init(gen: torch.Generator):
        if gen.device.type != device.type:
            raise ValueError(f"generator on {gen.device}, model on {device}")
        return transformer.init_transformer(gen, cfg)

    def make_cache(batch: int, seq_len: int):
        return L.make_attn_cache(cfg, batch, seq_len, cfg.n_layers, device)

    def prefill(p, x, cache):
        h, cache = transformer.transformer_prefill(p, x, cfg, cache)
        return L.logits_step(p["embed"], h[:, -1:, :], cfg), cache

    def decode_step(p, token, pos, cache):
        return transformer.transformer_decode(p, token, cfg, pos, cache)

    return Model(cfg, device, init, make_cache, prefill, decode_step)
