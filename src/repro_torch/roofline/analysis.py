"""Roofline of one step against one H100 (counterpart of
``repro.roofline.analysis``).

  compute = dot_FLOPs_per_device / PEAK_FLOPS_BF16
  memory  = op_bytes_per_device  / HBM_BW

The numerators come from ``roofline.op_stats`` over the whole step, run once
in one process (on fake tensors or on the card): per-device FLOPs and bytes
are the global count divided by the device count, the exact count for one
card on a 1x1 mesh. The port's kernels report their own work to the
counter, the flash-attention kernel's dots included, so nothing is added
analytically (the JAX package's ``flash_kernel_flops`` has no counterpart).
A one-process step has no SPMD collectives, so the JAX package's third
term, the collectives over the interconnect, has no counterpart either: the
bottleneck is the larger of the two counted terms.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.roofline import hw
from repro_torch.roofline.op_stats import OpStats

__all__ = ["roofline", "RooflineReport", "model_flops"]


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    n_devices: int
    flops_per_device: float  # counted dot flops
    bytes_per_device: float  # counted op bytes (eager, unfused)
    t_compute: float
    t_memory: float
    bottleneck: str
    model_flops: float
    useful_ratio: float  # MODEL_FLOPS / (flops_per_device * n_devices)
    peak_memory_per_device: Optional[float] = None

    def to_dict(self):
        return dataclasses.asdict(self)

    @property
    def roofline_time(self) -> float:
        return max(self.t_compute, self.t_memory)

    @property
    def roofline_fraction(self) -> float:
        """useful-FLOPs time / binding-roofline time: the fraction of the
        roofline-limited step that does model math."""
        t_useful = (self.model_flops / self.n_devices) / hw.PEAK_FLOPS_BF16
        return t_useful / self.roofline_time if self.roofline_time > 0 else 0.0


def model_flops(cfg, shape) -> float:
    """Reference useful FLOPs per step: 6·N_active·tokens (train),
    2·N_active·tokens (prefill/decode)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: 1 token per sequence


def roofline(
    arch: str,
    shape,
    cfg,
    stats: OpStats,
    n_devices: int,
    memory_stats: Optional[dict] = None,
) -> RooflineReport:
    """The report of one step counted into ``stats`` over the whole step,
    planned on ``n_devices`` devices."""
    flops = stats.dot_flops / n_devices
    nbytes = stats.op_bytes / n_devices

    t_c = flops / hw.PEAK_FLOPS_BF16
    t_m = nbytes / hw.HBM_BW
    bottleneck = "compute" if t_c >= t_m else "memory"

    mf = model_flops(cfg, shape)
    useful = mf / (flops * n_devices) if flops > 0 else 0.0

    return RooflineReport(
        arch=arch,
        shape=shape.name,
        n_devices=n_devices,
        flops_per_device=flops,
        bytes_per_device=nbytes,
        t_compute=t_c,
        t_memory=t_m,
        bottleneck=bottleneck,
        model_flops=mf,
        useful_ratio=useful,
        peak_memory_per_device=(memory_stats or {}).get("bytes"),
    )
