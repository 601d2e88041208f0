"""qwen3-moe-30b-a3b [moe]: 128 experts, top-8, per-expert FFN 768.
[hf:Qwen/Qwen3-30B-A3B; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    n_experts=128,
    top_k=8,
    d_ff_expert=768,
    vocab=151936,
    rope_theta=1e6,
    moe_impl="dense",  # perf iteration B1 (EXPERIMENTS.md §Perf)
)
