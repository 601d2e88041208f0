"""The port's hand-written CUDA kernels, their plain PyTorch versions and the
plain oracles (counterpart of ``repro.kernels``)."""

from repro_torch.kernels.ops import cim_matmul_op

__all__ = ["cim_matmul_op"]
