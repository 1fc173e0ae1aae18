"""Config package: dataclass counterparts of the JAX package's configs."""

from .env_config import EnvConfig
from .mcts_config import AlphaTriangleMCTSConfig, MCTSConfig
from .model_config import ModelConfig
from .persistence_config import PersistenceConfig
from .train_config import TrainConfig
from .validation import (
    EXPLICIT_FEATURES_DIM,
    FEATURES_PER_SHAPE,
    expected_other_features_dim,
)

__all__ = [
    "AlphaTriangleMCTSConfig",
    "EXPLICIT_FEATURES_DIM",
    "EnvConfig",
    "FEATURES_PER_SHAPE",
    "MCTSConfig",
    "ModelConfig",
    "PersistenceConfig",
    "TrainConfig",
    "expected_other_features_dim",
]
