"""Optimizers (AdamW, Adafactor), LR schedules and int8 gradient compression
of the PyTorch port (counterpart of ``repro.optim``): functions on trees of
tensors with the JAX package's arithmetic and state."""

from repro_torch.optim.adafactor import AdafactorState, adafactor_init, adafactor_update
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedules import warmup_cosine, warmup_linear


def make_optimizer(name: str):
    """Returns (init_fn, update_fn) for the configured optimizer."""
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(f"unknown optimizer {name!r}")


__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "AdafactorState",
    "adafactor_init",
    "adafactor_update",
    "warmup_cosine",
    "warmup_linear",
    "make_optimizer",
]
