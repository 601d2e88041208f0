"""The plain reference of the served models: float32 PyTorch with TF32 off,
no kernels, importing nothing of the program."""

from portbench.reference.model import Reference, rounder  # noqa: F401
