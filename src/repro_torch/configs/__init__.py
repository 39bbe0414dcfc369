from .base import SHAPES, ArchConfig, ShapeSpec, shape_applicable
from .registry import ARCHS, get_arch

__all__ = ["SHAPES", "ArchConfig", "ShapeSpec", "shape_applicable", "ARCHS",
           "get_arch"]
