"""Config package: dataclass counterparts of the JAX package's configs."""

from .app_config import APP_NAME
from .env_config import EnvConfig
from .league_config import LeagueConfig
from .mcts_config import AlphaTriangleMCTSConfig, MCTSConfig
from .mesh_config import MeshConfig
from .model_config import ModelConfig
from .persistence_config import PersistenceConfig
from .presets import (
    TUNED_PRESET_SCHEMA,
    baseline_preset,
    geometry_preset,
    load_tuned_preset,
)
from .telemetry_config import TelemetryConfig
from .train_config import TrainConfig
from .validation import (
    EXPLICIT_FEATURES_DIM,
    FEATURES_PER_SHAPE,
    expected_other_features_dim,
)

__all__ = [
    "APP_NAME",
    "AlphaTriangleMCTSConfig",
    "EXPLICIT_FEATURES_DIM",
    "EnvConfig",
    "FEATURES_PER_SHAPE",
    "LeagueConfig",
    "MCTSConfig",
    "MeshConfig",
    "ModelConfig",
    "PersistenceConfig",
    "TUNED_PRESET_SCHEMA",
    "TelemetryConfig",
    "TrainConfig",
    "baseline_preset",
    "expected_other_features_dim",
    "geometry_preset",
    "load_tuned_preset",
]
