"""pixtral-12b [vlm]: Pixtral-ViT frontend (STUB: precomputed patch
embeddings) + Mistral-Nemo-style 40L decoder backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1e6,
    input_kind="embeddings",  # modality frontend stub provides (B, S, D)
)
