"""Atomic, async checkpointing of the PyTorch port, in the JAX package's
layout."""

from repro_torch.checkpoint.ckpt import Checkpointer, latest_step, restore, save, save_async

__all__ = ["Checkpointer", "latest_step", "restore", "save", "save_async"]
