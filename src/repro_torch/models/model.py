"""Unified model API of the PyTorch port: ``build_model(cfg, device)`` ->
init / forward / loss_fn / make_cache / prefill / decode_step (counterpart
of ``repro.models.model``).

Families:
  * dense / moe  -> ``transformer.py``
  * mamba        -> the pure Mamba2 stack (here)
  * hybrid       -> ``zamba2.py``
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2, transformer, zamba2
from repro_torch.obs import trace as obs_trace

__all__ = ["Model", "build_model"]


class Model(NamedTuple):
    config: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Any]  # (generator on device) -> params
    forward: Callable[..., Any]  # (params, inputs) -> (h, aux)
    loss_fn: Callable[..., Any]  # (params, batch) -> (loss, metrics)
    make_cache: Callable[..., Any]  # (batch, seq_len) -> cache
    prefill: Callable[..., Any]  # (params, inputs, cache) -> (logits_last, cache)
    decode_step: Callable[..., Any]  # (params, token, pos, cache) -> (logits, cache)


# ---------------------------------------------------------------------------
# Pure Mamba2 stack
# ---------------------------------------------------------------------------


def _init_mamba_lm(gen: torch.Generator, cfg: ModelConfig):
    dt, dev = L.pdtype(cfg), gen.device
    return {
        "embed": L.init_embedding(gen, cfg),
        "mamba": mamba2.init_mamba(gen, cfg, cfg.n_layers),
        "ln": torch.zeros((cfg.n_layers, cfg.d_model), dtype=dt, device=dev),
        "ln_f": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    }


def _mamba_lm_train(p, x_in, cfg: ModelConfig):
    """The Mamba2 stack's training forward: no state, each layer recomputed
    in the backward pass when ``cfg.remat != "none"``."""
    x = L.embed(p["embed"], x_in, cfg)

    def body(x, i):
        y, _ = mamba2.mamba_forward(L.layer_slice(p["mamba"], i), L.rms_norm(x, p["ln"][i], cfg.norm_eps), cfg)
        return x + y

    for i in range(cfg.n_layers):
        x = checkpoint(body, x, i, use_reentrant=False) if cfg.remat != "none" else body(x, i)
    return L.rms_norm(x, p["ln_f"], cfg.norm_eps)


def _mamba_lm_forward(p, x_in, cfg: ModelConfig, cache, decode=False):
    """The Mamba2 stack over a prompt (prefill) or one token (decode),
    filling ``cache`` in place; returns the final-norm hidden states."""
    if not decode:
        x = L.embed(p["embed"], x_in, cfg)
    elif cfg.input_kind == "embeddings":
        x = x_in[:, None, :].to(L.cdtype(cfg))
    else:
        x = L.embed(p["embed"], x_in[:, None], cfg)
    step = mamba2.mamba_decode_step if decode else mamba2.mamba_forward
    for i in range(cfg.n_layers):
        with obs_trace.span("layer.mamba2", layer=i):
            hn = L.rms_norm(x, p["ln"][i], cfg.norm_eps)
            y, _ = step(L.layer_slice(p["mamba"], i), hn, cfg, L.layer_slice(cache, i))
            x = x + y
    return L.rms_norm(x, p["ln_f"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# build_model
# ---------------------------------------------------------------------------


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (CUDA unless the caller asks for
    the CPU; raises when CUDA is asked for and absent)."""
    device = resolve_device(device)
    fam = cfg.family

    if fam in ("dense", "moe"):
        init_fn = transformer.init_transformer
        fwd = lambda p, x: transformer.transformer_forward(p, x, cfg)  # noqa: E731

        def make_cache(batch: int, seq_len: int):
            return L.make_attn_cache(cfg, batch, seq_len, cfg.n_layers, device)

        def prefill(p, x, cache):
            h, cache = transformer.transformer_prefill(p, x, cfg, cache)
            return L.logits_step(p["embed"], h[:, -1:, :], cfg), cache

        def decode_step(p, token, pos, cache):
            return transformer.transformer_decode(p, token, cfg, pos, cache)

    elif fam == "mamba":
        init_fn = _init_mamba_lm

        def fwd(p, x):
            h = _mamba_lm_train(p, x, cfg)
            return h, torch.zeros((), device=h.device)

        def make_cache(batch: int, seq_len: int):
            return mamba2.make_mamba_state(cfg, batch, cfg.n_layers, device)

        def prefill(p, x, cache):
            h = _mamba_lm_forward(p, x, cfg, cache)
            return L.logits_step(p["embed"], h[:, -1:, :], cfg), cache

        def decode_step(p, token, pos, cache):
            h = _mamba_lm_forward(p, token, cfg, cache, decode=True)
            return L.logits_step(p["embed"], h, cfg), cache

    elif fam == "hybrid":
        init_fn = zamba2.init_zamba
        fwd = lambda p, x: zamba2.zamba_forward(p, x, cfg)  # noqa: E731

        def make_cache(batch: int, seq_len: int):
            return zamba2.make_zamba_cache(cfg, batch, seq_len, device)

        def prefill(p, x, cache):
            h, cache = zamba2.zamba_prefill(p, x, cfg, cache)
            return L.logits_step(p["embed"], h[:, -1:, :], cfg), cache

        def decode_step(p, token, pos, cache):
            return zamba2.zamba_decode(p, token, cfg, pos, cache)

    else:
        raise ValueError(f"unknown family {fam!r}")

    def init(gen: torch.Generator):
        if gen.device.type != device.type:
            raise ValueError(f"generator on {gen.device}, model on {device}")
        return init_fn(gen, cfg)

    def loss_fn(params, batch):
        h, aux = fwd(params, batch["inputs"])
        xent = L.chunked_xent(params["embed"], h, batch["labels"], cfg)
        loss = xent + cfg.router_aux_weight * aux
        return loss, {"xent": xent, "aux": aux}

    return Model(cfg, device, init, fwd, loss_fn, make_cache, prefill, decode_step)
