"""Architecture configs (assigned pool) + shape suites."""

from repro_torch.configs.base import ModelConfig, ShapeConfig, reduced
from repro_torch.configs.registry import ARCHS, for_shape, get_config
from repro_torch.configs.shapes import SHAPES, all_cells, valid_cells

__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "reduced",
    "ARCHS",
    "get_config",
    "for_shape",
    "SHAPES",
    "all_cells",
    "valid_cells",
]
