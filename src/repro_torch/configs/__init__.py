from .base import SHAPES, InputShape, ModelConfig
from .registry import ARCH_IDS, get_config, get_reduced, list_archs

__all__ = ["ModelConfig", "InputShape", "SHAPES", "get_config",
           "get_reduced", "list_archs", "ARCH_IDS"]
