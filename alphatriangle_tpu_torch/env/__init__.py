"""Batched triangle-puzzle environment on PyTorch tensors."""

from .engine import EnvState, TriangleEnv, where_state
from .game_state import GameState, Shape, get_env
from .geometry import EnvGeometry, build_geometry
from .shapes import ShapeBank, build_shape_bank, enumerate_shapes

__all__ = [
    "EnvGeometry",
    "EnvState",
    "GameState",
    "Shape",
    "ShapeBank",
    "TriangleEnv",
    "build_geometry",
    "build_shape_bank",
    "enumerate_shapes",
    "get_env",
    "where_state",
]
