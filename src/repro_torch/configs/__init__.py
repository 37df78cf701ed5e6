from repro_torch.configs.base import (
    ArchConfig, ShapeSpec, SHAPES, all_configs, get_config, shapes_for)

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "all_configs",
           "get_config", "shapes_for"]
