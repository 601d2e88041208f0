"""zamba2-7b [hybrid]: 81 Mamba2 layers + one shared-weight attention block
applied every 6 layers (13 applications). Long-context cells cap the shared
attention with a 4096 sliding window (applied by registry.for_shape).
[arXiv:2411.15242; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_headdim=64,
    share_period=6,
    rope_theta=1e4,
    subquadratic=True,
)
