"""The host side of the replay buffer: counterpart of the part of
`alphatriangle_tpu/rl/buffer.py::ExperienceBuffer` that the device ring
inherits.

That is readiness gating, the annealed PER exponent `beta`, the
`(|td| + eps)^alpha` priority update on the host SumTree mirror (f64)
and the ring counters `_pos` / `_size`. The host-resident SoA ring
(`add_dense`, `sample`) and the snapshot persistence wait for the slices
that run the synchronous loop and checkpoints.
"""

import numpy as np

from ..config.train_config import TrainConfig
from ..utils.sumtree import SumTree


class ExperienceBuffer:
    """Ring counters, PER knobs and the SumTree mirror."""

    def __init__(self, config: TrainConfig):
        self.config = config
        self.capacity = config.BUFFER_CAPACITY
        self.min_size_to_train = config.MIN_BUFFER_SIZE_TO_TRAIN
        self.use_per = config.USE_PER
        self.alpha = config.PER_ALPHA
        self.beta_initial = config.PER_BETA_INITIAL
        self.beta_final = config.PER_BETA_FINAL
        # TrainConfig derives this from the run length when USE_PER.
        self.beta_anneal_steps = config.PER_BETA_ANNEAL_STEPS or 1
        self.per_epsilon = config.PER_EPSILON
        self.tree = SumTree(self.capacity) if self.use_per else None
        self._pos = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def is_ready(self) -> bool:
        return self._size >= self.min_size_to_train

    def beta(self, train_step: int) -> float:
        """Annealed PER importance-sampling exponent at `train_step`."""
        frac = min(1.0, max(0.0, train_step / self.beta_anneal_steps))
        return self.beta_initial + frac * (self.beta_final - self.beta_initial)

    def update_priorities(self, indices: np.ndarray, td_errors: np.ndarray) -> None:
        """PER priority update on the mirror: `p = (|td| + eps)^alpha`,
        duplicates last-write-wins (SumTree.update_batch)."""
        if not self.use_per or self.tree is None:
            return
        indices = np.asarray(indices, dtype=np.int64).reshape(-1)
        td = np.asarray(td_errors, dtype=np.float64).reshape(-1)
        if indices.shape != td.shape:
            raise ValueError(f"indices {indices.shape} and td_errors {td.shape} must match.")
        if len(indices) == 0:
            return
        td = np.where(np.isfinite(td), td, 0.0)
        priorities = (np.abs(td) + self.per_epsilon) ** self.alpha
        self.tree.update_batch(indices, priorities)
