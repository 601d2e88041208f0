"""Device choice of the port's entry points (CUDA unless the caller asks
for the CPU, and never a quiet fall back to the CPU), the divisor that
keeps a division by a constant a true divide on every device, and the
synchronization that host clocks need."""

from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily

__all__ = ["divisor", "resolve_device", "synchronize"]


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises ``RuntimeError`` for a CUDA device
    when CUDA is not available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return device


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU), so a host
    clock read after it times the work and not its launch."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def divisor(value: float, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``value`` as a 0-d ``dtype`` tensor on ``like``'s device.

    Dividing by it is a true IEEE divide on every device, as on the CPU and
    in eager JAX: CUDA divides a tensor by a Python scalar through its
    reciprocal. Each constant is filled once per device and kept, so a call
    costs neither a copy from the host (a wait for the stream) nor a launch.
    A fake tensor (``FakeTensorMode``, the dry-run's counts) gets the kept
    real constant, made outside the fake mode, which lifts it: a fake
    constant is never kept."""
    if isinstance(like, FakeTensor):
        with unset_fake_temporarily():
            return _constant(value, dtype, like.device)
    return _constant(value, dtype, like.device)


@functools.lru_cache(maxsize=None)
def _constant(value, dtype, device) -> torch.Tensor:
    with torch.inference_mode(False):  # usable outside inference mode too
        return torch.full((), value, dtype=dtype, device=device)
