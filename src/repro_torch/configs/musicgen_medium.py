"""musicgen-medium [audio]: decoder-only over EnCodec tokens (frontend STUB:
token ids over the 2048-entry codebook). MHA (kv == heads). RoPE replaces the
original learned positions (deviation noted in DESIGN.md).
[arXiv:2306.05284; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="dense",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
    rope_theta=1e4,
    pad_vocab_multiple=256,
)
