"""Model zoo of the PyTorch port: the dense and MoE transformers, the Mamba2
stack and the Zamba2 hybrid."""

from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
