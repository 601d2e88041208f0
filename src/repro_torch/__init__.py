"""PyTorch/CUDA port of the CiM reproduction (``repro``, in JAX, is the
reference it is held against). Imports ``torch`` and numpy, never ``jax`` or
``repro``."""
