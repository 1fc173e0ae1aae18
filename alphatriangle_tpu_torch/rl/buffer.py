"""Experience replay on the host: counterpart of
`alphatriangle_tpu/rl/buffer.py::ExperienceBuffer`.

A fixed-shape struct-of-arrays ring in host memory (grid int8, since
cells are exactly {-1, 0, 1}; everything else float32), allocated on the
first add. Rows enter at the max-priority watermark of the SumTree under
PER; `sample` draws a stratified proportional batch with beta-annealed,
max-normalised importance weights from the buffer's own
`np.random.Generator` (seeded from `RANDOM_SEED`), so the same adds and
draws give the JAX buffer's slots and weights exactly. Priorities update
as `(|td| + eps)^alpha`.

`DeviceReplayBuffer` (rl/device_buffer.py) inherits the counters, the
PER knobs, the SumTree and the slot sampling, and keeps its ring on the
card. `get_state` / `set_state` snapshot the ring for a checkpoint's
buffer spill (stats/persistence.py), PER priorities included, in the
JAX buffer's snapshot format.
"""

import logging
from typing import Any, TypedDict

import numpy as np

from ..config.train_config import TrainConfig
from ..utils.sumtree import SumTree
from ..utils.types import DenseBatch, Experience, dense_policy_from_mapping

logger = logging.getLogger(__name__)


class DenseSample(TypedDict):
    """One sampled training batch plus PER bookkeeping."""

    batch: DenseBatch
    indices: np.ndarray  # (B,) int64 buffer slot indices
    weights: np.ndarray  # (B,) float32 IS weights (ones when uniform)


class ExperienceBuffer:
    """Uniform or prioritized replay over a dense SoA ring on the host."""

    is_device = False

    def __init__(
        self,
        config: TrainConfig,
        seed: "int | None" = None,
        action_dim: "int | None" = None,
        capacity: "int | None" = None,
    ):
        self.config = config
        # `capacity`: a ring smaller than BUFFER_CAPACITY (a dp shard's).
        self.capacity = capacity or config.BUFFER_CAPACITY
        self.min_size_to_train = config.MIN_BUFFER_SIZE_TO_TRAIN
        self.use_per = config.USE_PER
        self.alpha = config.PER_ALPHA
        self.beta_initial = config.PER_BETA_INITIAL
        self.beta_final = config.PER_BETA_FINAL
        # TrainConfig derives this from the run length when USE_PER.
        self.beta_anneal_steps = config.PER_BETA_ANNEAL_STEPS or 1
        self.per_epsilon = config.PER_EPSILON
        self._action_dim = action_dim
        self.tree = SumTree(self.capacity) if self.use_per else None
        self._rng = np.random.default_rng(config.RANDOM_SEED if seed is None else seed)
        self._storage: "dict[str, np.ndarray] | None" = None
        self._pos = 0
        self._size = 0

    # --- storage ----------------------------------------------------------

    def _ensure_storage(self, grid: np.ndarray, other: np.ndarray, policy: np.ndarray) -> None:
        if self._storage is not None:
            return
        self._storage = {
            "grid": np.zeros((self.capacity, *grid.shape[1:]), dtype=np.int8),
            "other_features": np.zeros((self.capacity, *other.shape[1:]), dtype=np.float32),
            "policy_target": np.zeros((self.capacity, *policy.shape[1:]), dtype=np.float32),
            "value_target": np.zeros(self.capacity, dtype=np.float32),
            "policy_weight": np.ones(self.capacity, dtype=np.float32),
        }

    # --- writes -----------------------------------------------------------

    def add_dense(
        self,
        grid: np.ndarray,
        other_features: np.ndarray,
        policy_target: np.ndarray,
        value_target: np.ndarray,
        policy_weight: "np.ndarray | None" = None,
    ) -> np.ndarray:
        """Ring-insert a batch of experiences from dense arrays; rows with
        a non-finite value are dropped. Returns the slot indices used. New
        rows enter at the SumTree's max priority under PER."""
        grid = np.asarray(grid)
        other_features = np.asarray(other_features, dtype=np.float32)
        policy_target = np.asarray(policy_target, dtype=np.float32)
        value_target = np.asarray(value_target, dtype=np.float32).reshape(-1)
        k = grid.shape[0]
        policy_weight = (
            np.ones(k, dtype=np.float32)
            if policy_weight is None
            else np.asarray(policy_weight, dtype=np.float32).reshape(-1)
        )
        if k == 0:
            return np.zeros(0, dtype=np.int64)
        finite = (
            np.isfinite(grid).all(axis=tuple(range(1, grid.ndim)))
            & np.isfinite(other_features).all(axis=tuple(range(1, other_features.ndim)))
            & np.isfinite(policy_target).all(axis=tuple(range(1, policy_target.ndim)))
            & np.isfinite(value_target)
        )
        if not finite.all():
            logger.warning("Dropping %d non-finite experiences on add.", int(k - finite.sum()))
            grid = grid[finite]
            other_features = other_features[finite]
            policy_target = policy_target[finite]
            value_target = value_target[finite]
            policy_weight = policy_weight[finite]
            k = grid.shape[0]
            if k == 0:
                return np.zeros(0, dtype=np.int64)
        self._ensure_storage(grid, other_features, policy_target)
        idxs = (self._pos + np.arange(k)) % self.capacity
        self._storage["grid"][idxs] = grid.astype(np.int8)
        self._storage["other_features"][idxs] = other_features
        self._storage["policy_target"][idxs] = policy_target
        self._storage["value_target"][idxs] = value_target
        self._storage["policy_weight"][idxs] = policy_weight
        if self.tree is not None:
            self.tree.update_batch(idxs, np.full(k, self.tree.max_priority, dtype=np.float64))
            self.tree.data_pointer = int((self._pos + k) % self.capacity)
            self.tree.n_entries = min(self._size + k, self.capacity)
        self._pos = int((self._pos + k) % self.capacity)
        self._size = min(self._size + k, self.capacity)
        return idxs

    def add(self, experience: Experience) -> None:
        """Insert one `(StateType, mapping, return)` tuple."""
        self.add_batch([experience])

    def add_batch(self, experiences: "list[Experience]") -> None:
        """Insert reference-style experience tuples."""
        if not experiences:
            return
        action_dim = self._infer_action_dim()
        grids = np.stack([e[0]["grid"] for e in experiences])
        others = np.stack([e[0]["other_features"] for e in experiences])
        policies = np.stack([dense_policy_from_mapping(e[1], action_dim) for e in experiences])
        values = np.asarray([e[2] for e in experiences], dtype=np.float32)
        self.add_dense(grids, others, policies, values)

    def _infer_action_dim(self) -> int:
        if self._action_dim is not None:
            return self._action_dim
        if self._storage is not None:
            return int(self._storage["policy_target"].shape[1])
        raise ValueError(
            "Tuple-form adds need the action space width before dense storage exists; "
            "construct ExperienceBuffer(..., action_dim=N)."
        )

    # --- reads ------------------------------------------------------------

    def __len__(self) -> int:
        return self._size

    def is_ready(self) -> bool:
        return self._size >= self.min_size_to_train

    def beta(self, train_step: int) -> float:
        """Annealed PER importance-sampling exponent at `train_step`."""
        frac = min(1.0, max(0.0, train_step / self.beta_anneal_steps))
        return self.beta_initial + frac * (self.beta_final - self.beta_initial)

    def _sample_indices(self, batch_size: int, current_train_step: "int | None"):
        """(slots, IS weights), or None until ready: stratified
        proportional PER with beta-annealed, max-normalised weights, or a
        uniform draw without PER."""
        if not self.is_ready() or batch_size > self._size:
            return None
        if self.use_per:
            if current_train_step is None:
                raise ValueError("current_train_step is required for PER sampling.")
            slots, priorities = self.tree.sample_batch(batch_size, self._rng)
            total = self.tree.total_priority
            probs = np.maximum(priorities, 1e-12) / max(total, 1e-12)
            weights = (self._size * probs) ** (-self.beta(current_train_step))
            weights = (weights / weights.max()).astype(np.float32)
        else:
            slots = self._rng.integers(0, self._size, size=batch_size)
            weights = np.ones(batch_size, dtype=np.float32)
        return slots, weights

    def sample(self, batch_size: int, current_train_step: "int | None" = None) -> "DenseSample | None":
        """A dense training batch from the host ring, or None until
        `is_ready()`. Under PER, `current_train_step` sets beta."""
        sampled = self._sample_indices(batch_size, current_train_step)
        if sampled is None:
            return None
        slots, weights = sampled
        batch: DenseBatch = {
            "grid": self._storage["grid"][slots].astype(np.float32),
            "other_features": self._storage["other_features"][slots],
            "policy_target": self._storage["policy_target"][slots],
            "value_target": self._storage["value_target"][slots],
            "weights": weights,
            "policy_weight": self._storage["policy_weight"][slots],
        }
        return {"batch": batch, "indices": slots.astype(np.int64), "weights": weights}

    def update_priorities(self, indices: np.ndarray, td_errors: np.ndarray) -> None:
        """PER priority update: `p = (|td| + eps)^alpha`, duplicates
        last-write-wins (SumTree.update_batch)."""
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

    # --- persistence ------------------------------------------------------

    def get_state(self) -> dict[str, Any]:
        """Snapshot for a buffer spill: cursor, size, the `size` rows of
        every column in slot order, and their SumTree priorities."""
        state: dict[str, Any] = {
            "pos": self._pos,
            "size": self._size,
            "storage": None,
            "priorities": None,
        }
        if self._storage is not None:
            state["storage"] = {
                k: v[: self._size].copy() if self._size < self.capacity else v.copy()
                for k, v in self._storage.items()
            }
        if self.tree is not None and self._size > 0:
            leaves = np.arange(self._size) + self.tree._cap2
            state["priorities"] = self.tree.tree[leaves].copy()
        return state

    def set_state(self, state: dict[str, Any]) -> None:
        """Restore a `get_state` snapshot, this package's or the JAX
        buffer's (its capacity may differ; contents are clipped to fit).

        Snapshot rows are in slot order; a wrapped ring's oldest row sits
        at the old write position, not slot 0. They are restored in
        chronological order (oldest at slot 0, the cursor after the
        newest), so later writes overwrite oldest first whatever the
        capacity, and clipping keeps the newest rows."""
        storage = state.get("storage")
        if storage is None:
            return
        old_size = int(state["size"])
        old_pos = int(state["pos"])
        # Slot -> chronological order (a no-op for an unwrapped ring,
        # whose cursor equals its size).
        order = np.roll(np.arange(old_size), -(old_pos % max(old_size, 1)))
        n = min(old_size, self.capacity)
        order = order[-n:]  # keep the newest on a shrink
        self._ensure_storage(
            storage["grid"][:1],
            storage["other_features"][:1],
            storage["policy_target"][:1],
        )
        # Columns added after a snapshot was written restore to an
        # explicit default; anything else missing is corruption.
        restore_defaults = {"policy_weight": 1.0}
        for k in self._storage:
            if k in storage:
                self._storage[k][:n] = storage[k][order]
            elif k in restore_defaults:
                self._storage[k][:n] = restore_defaults[k]
            else:
                raise KeyError(
                    f"Buffer snapshot is missing column {k!r} and no restore default is "
                    "defined for it."
                )
        self._size = n
        self._pos = n % self.capacity
        if self.tree is not None:
            prios = state.get("priorities")
            if prios is None:
                prios = np.ones(n, dtype=np.float64)
            else:
                prios = np.asarray(prios, dtype=np.float64)[order]
            # Every leaf is written: slots >= n are zeroed, or a smaller
            # snapshot restored over a fuller tree would leave stale
            # priorities in the total.
            full = np.zeros(self.capacity, dtype=np.float64)
            full[:n] = prios[:n]
            self.tree.update_batch(np.arange(self.capacity), full)
            self.tree.data_pointer = self._pos
            self.tree.n_entries = n
            # update_batch only ratchets the watermark up; the restored
            # rows' maximum replaces the pre-restore ring's.
            self.tree._max_priority_seen = float(max(1.0, full[:n].max(initial=0.0)))
