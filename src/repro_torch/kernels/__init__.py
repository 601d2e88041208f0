"""The port's hand-written CUDA kernels, their plain PyTorch versions and the
plain oracles (counterpart of ``repro.kernels``)."""

from repro_torch.kernels.ops import adc_quant_op, cim_matmul_op

__all__ = ["adc_quant_op", "cim_matmul_op"]
