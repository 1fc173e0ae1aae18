"""`extract_state_features(game_state, model_config)`: counterpart of
`alphatriangle_tpu/features/extractor.py`.

One game's features through the same batched `FeatureExtractor` that
self-play runs (at a batch of one, on the game's device), so host and
device features agree by construction; with the reference's finiteness
scrub.
"""

import logging

import numpy as np

from ..config.model_config import ModelConfig
from .core import FeatureExtractor

logger = logging.getLogger(__name__)


def scrub(name: str, x: np.ndarray) -> np.ndarray:
    """`x` with non-finite values set to 0, logged when there are any."""
    if np.all(np.isfinite(x)):
        return x
    logger.error("Non-finite values in %s; scrubbing to 0.", name)
    return np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def extract_state_features(game_state, model_config: ModelConfig) -> dict:
    """GameState -> {grid (C,H,W), other_features (F,)} float32 NumPy."""
    grid, other = FeatureExtractor(game_state._env, model_config).extract(game_state._state)
    other_np = scrub("other_features", other[0].cpu().numpy().astype(np.float32))
    grid_np = scrub("grid features", grid[0].cpu().numpy().astype(np.float32))
    return {"grid": grid_np, "other_features": other_np}
