"""RL result types: counterpart of `alphatriangle_tpu/rl/types.py`.

`SelfPlayResult` carries a dense block of experiences (NumPy arrays
from one harvest) and the harvest's episode statistics. Construction
drops structurally broken or non-finite rows, and rows whose policy
target is not a distribution, as the JAX validator does.
"""

import logging
from dataclasses import dataclass, field

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class SelfPlayResult:
    """One harvest of self-play experiences, dense-form."""

    grid: np.ndarray  # (N, C, H, W) float32
    other_features: np.ndarray  # (N, F) float32
    policy_target: np.ndarray  # (N, A) float32
    value_target: np.ndarray  # (N,) float32 n-step returns
    policy_weight: "np.ndarray | None" = None  # (N,) float32; None -> ones
    episode_scores: list = field(default_factory=list)
    episode_lengths: list = field(default_factory=list)
    # Weights version each finished episode started under: the
    # per-episode staleness tag.
    episode_start_versions: list = field(default_factory=list)
    num_episodes: int = 0
    num_truncated: int = 0
    total_simulations: int = 0
    # Root visits inherited through subtree reuse (0 without it): the
    # leaf evaluations the searches did not have to spend.
    total_reused_visits: int = 0
    # Oldest weights version the harvest's chunks played under: the
    # window-level staleness tag.
    trainer_step_at_episode_start: int = 0
    # Free-form harvest context: a league harvest carries its source and
    # each row's weights version (`row_versions`, league/emitter.py).
    context: dict = field(default_factory=dict)

    @property
    def num_experiences(self) -> int:
        return int(self.grid.shape[0])

    def __post_init__(self) -> None:
        n = self.grid.shape[0]
        if self.policy_weight is None:
            self.policy_weight = np.ones(n, dtype=np.float32)
        if self.policy_weight.shape[0] != n:
            raise ValueError(f"policy_weight rows {self.policy_weight.shape[0]} != {n}")
        if not (
            self.other_features.shape[0]
            == self.policy_target.shape[0]
            == self.value_target.shape[0]
            == n
        ):
            raise ValueError(
                "Experience arrays disagree on row count: "
                f"{self.grid.shape[0]}/{self.other_features.shape[0]}/"
                f"{self.policy_target.shape[0]}/{self.value_target.shape[0]}"
            )
        if n == 0:
            return
        keep = (
            np.isfinite(self.grid).all(axis=tuple(range(1, self.grid.ndim)))
            & np.isfinite(self.other_features).all(axis=1)
            & np.isfinite(self.policy_target).all(axis=1)
            & np.isfinite(self.value_target)
            & (np.abs(self.policy_target.sum(axis=1) - 1.0) < 1e-3)
        )
        if not keep.all():
            logger.warning(
                "SelfPlayResult: dropping %d invalid experiences of %d.", int(n - keep.sum()), n
            )
            self.grid = self.grid[keep]
            self.other_features = self.other_features[keep]
            self.policy_target = self.policy_target[keep]
            self.value_target = self.value_target[keep]
            self.policy_weight = self.policy_weight[keep]
