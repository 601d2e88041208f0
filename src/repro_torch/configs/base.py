"""Model / training configuration schema.

One ``ModelConfig`` describes any architecture in the assigned pool
(dense / GQA / MoE / SSM / hybrid decoder LMs, plus modality-stub backbones).
Configs are plain frozen dataclasses — hashable, usable as cache keys.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.cim_linear import CiMConfig

__all__ = ["ModelConfig", "ShapeConfig", "reduced"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | mamba | hybrid
    n_layers: int
    d_model: int
    vocab: int
    # attention (ignored for family == mamba)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 128
    d_ff: int = 0
    qkv_bias: bool = False
    rope_theta: float = 1e6
    sliding_window: Optional[int] = None  # cap attention span (zamba2 long ctx)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_impl: str = "scatter"  # scatter (GShard dispatch) | dense (masked, collective-minimal)
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2): one shared-weight attention block applied every
    # `share_period` mamba layers
    share_period: int = 0
    # embedding / head
    tie_embeddings: bool = False
    input_kind: str = "tokens"  # tokens | embeddings (modality-frontend stub)
    pad_vocab_multiple: int = 256
    norm_eps: float = 1e-5
    # numerics / execution
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"  # none | full
    attn_chunk: int = 1024  # KV-chunk for blocked attention
    attn_impl: str = "blocked"  # blocked | flash (fused CUDA kernel; fwd-only prefill)
    loss_chunk: int = 512  # sequence-chunk for the unembed/softmax-xent
    optimizer: str = "adamw"  # adamw | adafactor
    # the paper's technique: CiM quantization applied to linears (None = off)
    cim: Optional[CiMConfig] = None
    kv_quant_int8: bool = False  # int8 KV cache for serving (perf iter C2)
    # notes for DESIGN/EXPERIMENTS (e.g. long-context applicability)
    subquadratic: bool = False  # supports long_500k decode

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def n_params(self) -> int:
        """Total parameter count (analytic)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim + self.n_heads * self.head_dim * d
        per_mlp = 3 * d * f
        per_moe = d * self.n_experts + 3 * self.n_experts * d * self.d_ff_expert if self.n_experts else 0
        per_mamba = 0
        if self.ssm_state:
            di, h, ns = self.d_inner, self.ssm_heads, self.ssm_state
            zxbcdt = 2 * di + 2 * ns + h
            per_mamba = d * zxbcdt + (di + 2 * ns) * self.ssm_conv_width + 3 * h + di * d + di
        if self.family == "dense":
            body = self.n_layers * (per_attn + per_mlp + 2 * d)
        elif self.family == "moe":
            body = self.n_layers * (per_attn + per_moe + 2 * d)
        elif self.family == "mamba":
            body = self.n_layers * (per_mamba + d)
        elif self.family == "hybrid":
            n_shared = self.n_layers // max(self.share_period, 1)
            body = self.n_layers * (per_mamba + d) + (per_attn + per_mlp + 2 * d)
        else:
            raise ValueError(self.family)
        return emb + body + d  # final norm

    def n_active_params(self) -> int:
        """Active parameters per token (MoE routes top_k of n_experts)."""
        if not self.n_experts:
            return self.n_params()
        d = self.d_model
        per_moe_total = 3 * self.n_experts * d * self.d_ff_expert
        per_moe_active = 3 * self.top_k * d * self.d_ff_expert
        return self.n_params() - self.n_layers * (per_moe_total - per_moe_active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Small same-family config for CPU smoke tests."""
    base = dict(
        n_layers=2,
        d_model=64,
        vocab=256,
        head_dim=16,
        rope_theta=1e4,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=64,
        loss_chunk=64,
        pad_vocab_multiple=16,
    )
    if cfg.n_heads:
        base.update(n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)), d_ff=128)
    if cfg.n_experts:
        base.update(n_experts=8, top_k=2, d_ff_expert=32)
    if cfg.ssm_state:
        base.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32)
    if cfg.share_period:
        base.update(share_period=2, n_layers=5, n_heads=4, n_kv_heads=4, d_ff=128)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
