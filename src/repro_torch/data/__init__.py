"""Data pipelines of the PyTorch port: deterministic synthetic LM tokens and
procedural MNIST (numpy; the same arrays as the JAX package's)."""

from repro_torch.data.mnist_synth import load_mnist_synth
from repro_torch.data.tokens import TokenPipeline

__all__ = ["TokenPipeline", "load_mnist_synth"]
