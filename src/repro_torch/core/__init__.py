"""Core library: the CiM-quantized linear layer of the PyTorch port."""

from repro_torch.core.cim_linear import CiMConfig, cim_matmul

__all__ = ["CiMConfig", "cim_matmul"]
