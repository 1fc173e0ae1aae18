"""Feature-layout helpers: counterpart of the two constants and the
dimension check in `alphatriangle_tpu/config/validation.py`."""

from .env_config import EnvConfig

# Feature layout constants shared with features/.
FEATURES_PER_SHAPE = 7
EXPLICIT_FEATURES_DIM = 6


def expected_other_features_dim(env: EnvConfig) -> int:
    """Per-slot shape feats + slot availability + scalar feats."""
    return env.NUM_SHAPE_SLOTS * FEATURES_PER_SHAPE + env.NUM_SHAPE_SLOTS + (
        EXPLICIT_FEATURES_DIM
    )
