"""Fault-tolerance runtime of the PyTorch port (a copy of ``repro.ft.watchdog``):
heartbeats, straggler detection, supervised restart.

At cluster scale this is the per-host agent: it publishes heartbeats (here, a
file; in production, your scheduler's liveness channel), tracks the step-time
EMA, flags stragglers (> ``straggler_factor`` × EMA), and the supervisor
restarts the training function from the latest checkpoint on failure —
crash-consistent thanks to atomic checkpoints + seekable data (data/tokens.py
reproduces the exact batch stream at any restored step).
"""

from __future__ import annotations

import json
import time
import traceback
from pathlib import Path
from typing import Callable, Optional

__all__ = ["Watchdog", "run_with_restart"]


class Watchdog:
    def __init__(
        self,
        heartbeat_file: str | Path = "results/heartbeat.json",
        straggler_factor: float = 2.5,
        ema_alpha: float = 0.1,
    ):
        self.file = Path(heartbeat_file)
        self.factor = straggler_factor
        self.alpha = ema_alpha
        self.ema: Optional[float] = None
        self.last_t: Optional[float] = None
        self.stragglers = 0

    def step(self, step: int, metrics: dict | None = None) -> dict:
        """Call once per train step. Returns {straggler: bool, ema_s: float}."""
        now = time.time()
        out = {"straggler": False, "ema_s": None}
        if self.last_t is not None:
            dt = now - self.last_t
            if self.ema is None:
                self.ema = dt
            else:
                if dt > self.factor * self.ema:
                    out["straggler"] = True
                    self.stragglers += 1
                self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
            out["ema_s"] = self.ema
        self.last_t = now
        self.file.parent.mkdir(parents=True, exist_ok=True)
        self.file.write_text(
            json.dumps(
                {
                    "step": step,
                    "time": now,
                    "ema_s": self.ema,
                    "stragglers": self.stragglers,
                    **{k: float(v) for k, v in (metrics or {}).items()},
                }
            )
        )
        return out


def run_with_restart(
    fn: Callable[[Optional[int]], int],
    max_restarts: int = 3,
    on_failure: Optional[Callable[[Exception, int], None]] = None,
) -> int:
    """Supervised execution: ``fn(resume_step)`` -> final step.

    On exception, restarts from the latest checkpoint (fn re-reads it).
    Simulates the cluster supervisor's reschedule-on-node-failure loop.
    """
    attempt = 0
    resume: Optional[int] = None
    while True:
        try:
            return fn(resume)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — supervisor catches everything
            attempt += 1
            if on_failure:
                on_failure(e, attempt)
            if attempt > max_restarts:
                raise
            print(f"[ft] failure #{attempt}: {e!r}; restarting from latest ckpt")
            traceback.print_exc()
            resume = None  # fn re-discovers latest checkpoint
