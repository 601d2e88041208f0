"""Dense / GQA / MoE decoder stack of the PyTorch port (counterpart of
``repro.models.transformer``): the training forward, prefill and decode.

Per-layer parameters stay stacked on a leading L dim, as in the JAX package,
and are walked with a Python loop where JAX uses ``lax.scan``. With
``cfg.remat != "none"`` each training layer is recomputed in the backward
pass (``torch.utils.checkpoint``, as JAX's ``jax.checkpoint`` of the scan
body). The KV cache is filled in place.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe, moe_ffn, moe_ffn_dense
from repro_torch.obs import trace as obs_trace

__all__ = ["init_transformer", "transformer_forward", "transformer_prefill", "transformer_decode"]


def init_transformer(gen: torch.Generator, cfg: ModelConfig):
    """Random init from ``gen``, on ``gen.device``; same names, shapes and
    dtypes as the JAX package's ``init_transformer``."""
    nl, dt, dev = cfg.n_layers, L.pdtype(cfg), gen.device
    p = {
        "embed": L.init_embedding(gen, cfg),
        "attn": L.init_attention(gen, cfg, nl),
        "ln1": torch.zeros((nl, cfg.d_model), dtype=dt, device=dev),
        "ln2": torch.zeros((nl, cfg.d_model), dtype=dt, device=dev),
        "ln_f": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    }
    if cfg.n_experts:
        p["moe"] = init_moe(gen, cfg, nl)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, nl)
    return p


def _ffn(p: dict, i: int, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Layer ``i``'s feed-forward: the MLP, or the MoE of ``cfg.moe_impl``."""
    if not cfg.n_experts:
        return L.mlp(L.layer_slice(p["mlp"], i), x, cfg)
    ffn = moe_ffn_dense if cfg.moe_impl == "dense" else moe_ffn
    return ffn(L.layer_slice(p["moe"], i), x, cfg)[0]


def _ffn_span(cfg: ModelConfig) -> str:
    return "layer.moe" if cfg.n_experts else "layer.mlp"


def _block_train(x, lp, cfg: ModelConfig, positions):
    """One training layer: (x, the layer's MoE aux loss or 0)."""
    h, _ = L.attention(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, positions)
    x = x + h
    hn = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        ffn = moe_ffn_dense if cfg.moe_impl == "dense" else moe_ffn
        y, aux = ffn(lp["moe"], hn, cfg)
    else:
        y, aux = L.mlp(lp["mlp"], hn, cfg), torch.zeros((), device=x.device)
    return x + y, aux


def _layer_params(p: dict, cfg: ModelConfig, i: int) -> dict:
    ffn = "moe" if cfg.n_experts else "mlp"
    return L.layer_slice({"attn": p["attn"], "ln1": p["ln1"], "ln2": p["ln2"], ffn: p[ffn]}, i)


def transformer_forward(p: dict, x_in: torch.Tensor, cfg: ModelConfig):
    """Training forward: (B, S) tokens or (B, S, D) embeddings -> (h, aux),
    ``aux`` the MoE load-balance loss averaged over the layers."""
    x = L.embed(p["embed"], x_in, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer_params(p, cfg, i)
        if cfg.remat != "none":
            x, a = checkpoint(_block_train, x, lp, cfg, positions, use_reentrant=False)
        else:
            x, a = _block_train(x, lp, cfg, positions)
        aux = aux + a
    return L.rms_norm(x, p["ln_f"], cfg.norm_eps), aux / max(cfg.n_layers, 1)


def transformer_prefill(p: dict, x_in: torch.Tensor, cfg: ModelConfig, cache: dict):
    """Prefill: fills the per-layer KV cache, returns (h, cache)."""
    x = L.embed(p["embed"], x_in, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    ffn = _ffn_span(cfg)
    for i in range(cfg.n_layers):
        with obs_trace.span("layer.attention", layer=i):
            hn = L.rms_norm(x, p["ln1"][i], cfg.norm_eps)
            h, _ = L.attention(L.layer_slice(p["attn"], i), hn, cfg, positions, cache=L.layer_slice(cache, i))
            x = x + h
        with obs_trace.span(ffn, layer=i):
            hn = L.rms_norm(x, p["ln2"][i], cfg.norm_eps)
            x = x + _ffn(p, i, hn, cfg)
    return L.rms_norm(x, p["ln_f"], cfg.norm_eps), cache


def transformer_decode(p: dict, token: torch.Tensor, cfg: ModelConfig, pos: int, cache: dict):
    """One decode step: token (B,) or embedding (B, D) -> (logits, cache)."""
    if cfg.input_kind == "embeddings":
        x = token[:, None, :].to(L.cdtype(cfg))
    else:
        x = L.embed(p["embed"], token[:, None], cfg)
    ffn = _ffn_span(cfg)
    for i in range(cfg.n_layers):
        with obs_trace.span("layer.attention", layer=i):
            hn = L.rms_norm(x, p["ln1"][i], cfg.norm_eps)
            h, _ = L.decode_attention(L.layer_slice(p["attn"], i), hn, cfg, pos, L.layer_slice(cache, i))
            x = x + h
        with obs_trace.span(ffn, layer=i):
            hn = L.rms_norm(x, p["ln2"][i], cfg.norm_eps)
            x = x + _ffn(p, i, hn, cfg)
    h = L.rms_norm(x, p["ln_f"], cfg.norm_eps)
    return L.logits_step(p["embed"], h, cfg), cache
