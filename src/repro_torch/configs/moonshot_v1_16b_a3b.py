"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    n_experts=64,
    top_k=6,
    d_ff_expert=1408,
    vocab=163840,
    rope_theta=5e4,
    moe_impl="dense",  # perf iteration B1 (EXPERIMENTS.md §Perf)
)
