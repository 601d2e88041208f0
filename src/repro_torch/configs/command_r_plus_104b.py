"""command-r-plus-104b [dense]: GQA, no biases.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab=256000,
    rope_theta=7.5e4,
)
