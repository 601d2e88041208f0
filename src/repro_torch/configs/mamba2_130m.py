"""mamba2-130m [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="mamba",
    n_layers=24,
    d_model=768,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    tie_embeddings=True,
    subquadratic=True,
)
