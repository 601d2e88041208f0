"""Fault tolerance of the PyTorch port: watchdog, straggler detection,
supervised restart."""

from repro_torch.ft.watchdog import Watchdog, run_with_restart

__all__ = ["Watchdog", "run_with_restart"]
