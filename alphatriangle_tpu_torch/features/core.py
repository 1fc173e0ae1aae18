"""Batched state -> network-input features: counterpart of
`alphatriangle_tpu/features/core.py`, exact in float32.

Layout:
- grid: (B, GRID_INPUT_CHANNELS, R, C) float32; channel 0 holds
  1.0 occupied-playable / 0.0 empty / -1.0 death.
- other_features, concatenated: 7 shape features per slot (from a
  precomputed table; zeros for empty slots), slot availability, and 6
  scalars (score, mean and max height, holes, bumpiness, step).
"""

import numpy as np
import torch

from ..config.env_config import EnvConfig
from ..config.model_config import ModelConfig
from ..config.validation import FEATURES_PER_SHAPE, expected_other_features_dim
from ..env.engine import EnvState, TriangleEnv
from ..env.shapes import ShapeBank
from . import grid_features


def build_shape_feature_table(bank: ShapeBank, cfg: EnvConfig) -> np.ndarray:
    """(S + 1, 7) float32: row s = features of shape s; last row = zeros
    (the gather target for empty slots)."""
    table = np.zeros((bank.n_shapes + 1, FEATURES_PER_SHAPE), dtype=np.float32)
    for s, cells in enumerate(bank.shapes):
        n = len(cells)
        ups = sum(1 for r, c in cells if (r + c) % 2 == 0)
        min_r = min(r for r, _ in cells)
        max_r = max(r for r, _ in cells)
        min_c = min(c for _, c in cells)
        max_c = max(c for _, c in cells)
        height = max_r - min_r + 1
        width_eff = (max_c - min_c + 1) * 0.75 + 0.25
        table[s] = (
            np.clip(n / 5.0, 0.0, 1.0),
            ups / n,
            (n - ups) / n,
            np.clip(height / cfg.ROWS, 0.0, 1.0),
            np.clip(width_eff / cfg.COLS, 0.0, 1.0),
            np.clip(((min_r + max_r) / 2.0) / cfg.ROWS, 0.0, 1.0),
            np.clip(((min_c + max_c) / 2.0) / cfg.COLS, 0.0, 1.0),
        )
    return table


class FeatureExtractor:
    """Feature pipeline bound to one (env, ModelConfig) pair; holds only
    device-resident constants."""

    def __init__(self, env: TriangleEnv, model_config: ModelConfig):
        self.env = env
        self.model_config = model_config
        expected = expected_other_features_dim(env.cfg)
        if model_config.OTHER_NN_INPUT_FEATURES_DIM != expected:
            raise ValueError(
                f"ModelConfig.OTHER_NN_INPUT_FEATURES_DIM="
                f"{model_config.OTHER_NN_INPUT_FEATURES_DIM} does not match "
                f"the feature layout ({expected}) for this EnvConfig."
            )
        self.other_dim = expected
        dev = env.device
        self._shape_table = torch.as_tensor(
            build_shape_feature_table(env.bank, env.cfg), device=dev
        )
        self._death = torch.as_tensor(env.geometry.death, device=dev)
        self._n_playable = max(int((~env.geometry.death).sum()), 1)

    def extract(self, state: EnvState) -> tuple[torch.Tensor, torch.Tensor]:
        """(B,)-batched state -> (grid (B,C,R,W), other_features (B,F))."""
        cfg = self.env.cfg
        batch = state.done.shape[0]
        death = self._death
        occupied = self.env.unpack_grid(state.occupied)  # (B, R, C) bool
        minus_one = torch.tensor(-1.0, device=death.device)
        grid0 = torch.where(death, minus_one, occupied.to(torch.float32))
        grid = torch.zeros(
            (batch, self.model_config.GRID_INPUT_CHANNELS, cfg.ROWS, cfg.COLS),
            dtype=torch.float32,
            device=death.device,
        )
        grid[:, 0] = grid0

        empty_row = self._shape_table.shape[0] - 1
        slot_rows = torch.where(
            state.shape_idx >= 0, state.shape_idx.long(), empty_row
        )
        shape_feats = self._shape_table[slot_rows].reshape(batch, -1)
        availability = (state.shape_idx >= 0).to(torch.float32)

        heights = grid_features.column_heights(occupied, death)
        holes = grid_features.count_holes(occupied, death, heights)
        bump = grid_features.bumpiness(heights)
        rows_f = float(cfg.ROWS)
        # XLA lowers a mean as the sum times the float32 reciprocal of
        # the count; the same two roundings keep this feature exact.
        inv_cols = float(np.float32(1.0) / np.float32(cfg.COLS))
        explicit = torch.stack(
            [
                torch.clamp(state.score / 100.0, -5.0, 5.0),
                heights.to(torch.float32).sum(dim=-1) * inv_cols / rows_f,
                heights.amax(dim=-1).to(torch.float32) / rows_f,
                holes.to(torch.float32) / self._n_playable,
                (bump / max(cfg.COLS - 1, 1)) / rows_f,
                torch.clamp(state.step_count.to(torch.float32) / 1000.0, 0.0, 1.0),
            ],
            dim=-1,
        )
        other = torch.cat([shape_feats, availability, explicit], dim=-1)
        return grid, other
