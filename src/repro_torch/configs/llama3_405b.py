"""llama3-405b [dense]: GQA, 128k vocab. Adafactor optimizer (Adam moments at
405B would not fit the single-pod HBM budget; see EXPERIMENTS.md §Dry-run).
[arXiv:2407.21783; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab=128256,
    rope_theta=5e5,
    optimizer="adafactor",
)
