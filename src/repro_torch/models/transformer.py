"""Dense GQA decoder stack of the PyTorch port (counterpart of
``repro.models.transformer``, dense family).

Per-layer parameters stay stacked on a leading L dim, as in the JAX package,
and are walked with a Python loop where JAX uses ``lax.scan``. The KV cache
is filled in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

__all__ = ["init_transformer", "transformer_prefill", "transformer_decode"]


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            "MoE layers are not ported to PyTorch yet (ROADMAP.md, port queue A: models/moe)"
        )


def init_transformer(gen: torch.Generator, cfg: ModelConfig):
    """Random init from ``gen``, on ``gen.device``; same names, shapes and
    dtypes as the JAX package's ``init_transformer``."""
    _dense_only(cfg)
    nl, dt, dev = cfg.n_layers, L.pdtype(cfg), gen.device
    return {
        "embed": L.init_embedding(gen, cfg),
        "attn": L.init_attention(gen, cfg, nl),
        "ln1": torch.zeros((nl, cfg.d_model), dtype=dt, device=dev),
        "ln2": torch.zeros((nl, cfg.d_model), dtype=dt, device=dev),
        "ln_f": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
        "mlp": L.init_mlp(gen, cfg, nl),
    }


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views, so cache writes land in place)."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in tree.items()}


def transformer_prefill(p: dict, x_in: torch.Tensor, cfg: ModelConfig, cache: dict):
    """Prefill: fills the per-layer KV cache, returns (h, cache)."""
    _dense_only(cfg)
    x = L.embed(p["embed"], x_in, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        hn = L.rms_norm(x, p["ln1"][i], cfg.norm_eps)
        h, _ = L.attention(_layer(p["attn"], i), hn, cfg, positions, cache=_layer(cache, i))
        x = x + h
        hn = L.rms_norm(x, p["ln2"][i], cfg.norm_eps)
        x = x + L.mlp(_layer(p["mlp"], i), hn, cfg)
    return L.rms_norm(x, p["ln_f"], cfg.norm_eps), cache


def transformer_decode(p: dict, token: torch.Tensor, cfg: ModelConfig, pos: int, cache: dict):
    """One decode step: token (B,) or embedding (B, D) -> (logits, cache)."""
    _dense_only(cfg)
    if cfg.input_kind == "embeddings":
        x = token[:, None, :].to(L.cdtype(cfg))
    else:
        x = L.embed(p["embed"], token[:, None], cfg)
    for i in range(cfg.n_layers):
        hn = L.rms_norm(x, p["ln1"][i], cfg.norm_eps)
        h, _ = L.decode_attention(_layer(p["attn"], i), hn, cfg, pos, _layer(cache, i))
        x = x + h
        hn = L.rms_norm(x, p["ln2"][i], cfg.norm_eps)
        x = x + L.mlp(_layer(p["mlp"], i), hn, cfg)
    h = L.rms_norm(x, p["ln_f"], cfg.norm_eps)
    return L.logits_step(p["embed"], h, cfg), cache
