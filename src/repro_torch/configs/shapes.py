"""Assigned input-shape suites (seq_len x global_batch per kind)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["SHAPES", "valid_cells", "all_cells"]

SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode"),
}


def valid_cells(cfg: ModelConfig) -> list[str]:
    """Shape names applicable to this architecture. long_500k requires
    sub-quadratic attention (SSM / hybrid) per the assignment."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return names


def all_cells(configs: dict) -> list[tuple[str, str]]:
    out = []
    for name, cfg in configs.items():
        for sh in valid_cells(cfg):
            out.append((name, sh))
    return out
