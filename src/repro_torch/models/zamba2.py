"""Zamba2-style hybrid of the PyTorch port: a Mamba2 backbone and one
shared-weight attention block (counterpart of ``repro.models.zamba2``): the
training forward, prefill and decode.

``n_layers`` Mamba2 layers are split into G = n_layers // share_period
groups, each followed by the shared transformer block, and a tail of
``n_layers % share_period`` Mamba2 layers. The shared block's weights are
the same at every application, but each application has its own KV cache.
Layers are walked with Python loops where the JAX package uses ``lax.scan``;
states and caches are filled in place. The training forward recomputes as
the JAX package's does with ``cfg.remat != "none"``: each group (its Mamba2
layers and the shared block) as one unit, and each tail layer alone.
Under ``repro_torch.obs`` tracing, prefill and decode record a
``layer.mamba2`` span per Mamba2 layer (``layer`` its index) and, per
application of the shared block, a ``layer.attention`` and a ``layer.mlp``
span (``layer`` the application's index), each with its norm and residual
add.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.mamba2 import init_mamba, make_mamba_state, mamba_decode_step, mamba_forward
from repro_torch.obs import trace as obs_trace

__all__ = ["init_zamba", "zamba_forward", "zamba_prefill", "zamba_decode", "make_zamba_cache"]


def _split(cfg: ModelConfig):
    g = cfg.n_layers // cfg.share_period
    tail = cfg.n_layers - g * cfg.share_period
    return g, cfg.share_period, tail


def init_zamba(gen: torch.Generator, cfg: ModelConfig):
    """Random init from ``gen`` (the JAX package's names, shapes and dtypes;
    the shared block without a layer dim)."""
    dt, dev = L.pdtype(cfg), gen.device
    return {
        "embed": L.init_embedding(gen, cfg),
        "mamba": init_mamba(gen, cfg, cfg.n_layers),
        "mamba_ln": torch.zeros((cfg.n_layers, cfg.d_model), dtype=dt, device=dev),
        "shared": {
            "attn": L.layer_slice(L.init_attention(gen, cfg, 1), 0),
            "mlp": L.layer_slice(L.init_mlp(gen, cfg, 1), 0),
            "ln1": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
            "ln2": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
        },
        "ln_f": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    }


def _schedule(cfg: ModelConfig):
    """The layer order: ``("mamba", i)`` for Mamba2 layer i, ``("shared",
    j)`` for the shared block's j-th application (its KV cache j)."""
    g, period, tail = _split(cfg)
    for j in range(g):
        for i in range(j * period, (j + 1) * period):
            yield "mamba", i
        yield "shared", j
    for i in range(g * period, g * period + tail):
        yield "mamba", i


def _shared_block(x, shared, cfg, positions, cache=None, pos=None, decode=False, app=None):
    """The shared block's ``app``-th application."""
    with obs_trace.span("layer.attention", layer=app):
        hn = L.rms_norm(x, shared["ln1"], cfg.norm_eps)
        if decode:
            h, _ = L.decode_attention(shared["attn"], hn, cfg, pos, cache)
        else:
            h, _ = L.attention(shared["attn"], hn, cfg, positions, cache=cache)
        x = x + h
    with obs_trace.span("layer.mlp", layer=app):
        return x + L.mlp(shared["mlp"], L.rms_norm(x, shared["ln2"], cfg.norm_eps), cfg)


def _walk(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict, positions=None, pos=None, decode=False):
    step = mamba_decode_step if decode else mamba_forward
    for kind, i in _schedule(cfg):
        if kind == "shared":
            x = _shared_block(x, p["shared"], cfg, positions, L.layer_slice(cache["attn"], i), pos, decode, app=i)
            continue
        with obs_trace.span("layer.mamba2", layer=i):
            hn = L.rms_norm(x, p["mamba_ln"][i], cfg.norm_eps)
            y, _ = step(L.layer_slice(p["mamba"], i), hn, cfg, L.layer_slice(cache["mamba"], i))
            x = x + y
    return L.rms_norm(x, p["ln_f"], cfg.norm_eps)


def zamba_forward(p: dict, x_in: torch.Tensor, cfg: ModelConfig):
    """Training forward -> (h, aux = 0)."""
    x = L.embed(p["embed"], x_in, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    g, period, tail = _split(cfg)

    def inner(x, i):
        y, _ = mamba_forward(L.layer_slice(p["mamba"], i), L.rms_norm(x, p["mamba_ln"][i], cfg.norm_eps), cfg)
        return x + y

    def group(x, j):
        for i in range(j * period, (j + 1) * period):
            x = inner(x, i)
        return _shared_block(x, p["shared"], cfg, positions, app=j)

    remat = cfg.remat != "none"
    for j in range(g):
        x = checkpoint(group, x, j, use_reentrant=False) if remat else group(x, j)
    for i in range(g * period, g * period + tail):
        x = checkpoint(inner, x, i, use_reentrant=False) if remat else inner(x, i)
    return L.rms_norm(x, p["ln_f"], cfg.norm_eps), torch.zeros((), device=x.device)


def make_zamba_cache(cfg: ModelConfig, batch: int, seq_len: int, device):
    g, _, _ = _split(cfg)
    return {
        "mamba": make_mamba_state(cfg, batch, cfg.n_layers, device),
        "attn": L.make_attn_cache(cfg, batch, seq_len, g, device),
    }


def zamba_prefill(p: dict, x_in: torch.Tensor, cfg: ModelConfig, cache: dict):
    """Prefill: fills the Mamba2 states and the shared block's KV caches,
    returns ``(h, cache)``."""
    x = L.embed(p["embed"], x_in, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return _walk(p, x, cfg, cache, positions=positions), cache


def zamba_decode(p: dict, token: torch.Tensor, cfg: ModelConfig, pos: int, cache: dict):
    """One decode step: token (B,) or embedding (B, D) -> (logits, cache)."""
    if cfg.input_kind == "embeddings":
        x = token[:, None, :].to(L.cdtype(cfg))
    else:
        x = L.embed(p["embed"], token[:, None], cfg)
    h = _walk(p, x, cfg, cache, pos=pos, decode=True)
    return L.logits_step(p["embed"], h, cfg), cache
