"""Feature extraction: game state -> network inputs."""

from .core import FeatureExtractor, build_shape_feature_table
from .extractor import extract_state_features
from .grid_features import bumpiness, column_heights, count_holes

__all__ = [
    "FeatureExtractor",
    "build_shape_feature_table",
    "bumpiness",
    "column_heights",
    "count_holes",
    "extract_state_features",
]
