"""Device-resident experience replay: counterpart of
`alphatriangle_tpu/rl/device_buffer.py` (`ring_scatter`,
`DeviceReplayBuffer`) on CUDA tensors.

The ring lives on the card: grid int8 (cells are exactly {-1, 0, 1}),
everything else float32, plus one trash row at index `capacity` that
absorbs the scatters of invalid rows. Ingest flattens a rollout chunk's
masked experience blocks (still on the card), validates them and writes
the valid ones at consecutive ring slots from the running cursor; only
the row count reaches the host, which is all the SumTree mirror needs:
rows occupy slots `[cursor, cursor + count) % capacity` in order and
enter at the max-priority watermark.

`ring_scatter` updates the storage tensors in place (nothing else holds
the old ring, which the JAX version replaces functionally). Writes at
distinct slots are deterministic on the card; the trash row takes many
writes in no defined order, which is harmless because it is never
sampled.

Host rows enter the same way (`add_dense`: one upload, then the same
scatter), and the synchronous and overlapped loops sample slots on the
host SumTree (`sample`: indices and IS weights only) for the learner to
gather on the card (`Trainer.train_steps_from`).

`get_state` / `set_state` give the host ring's snapshot (one bulk copy of
the `size` rows to the host; the host ring and SumTree rebuilt by the
parent, then one upload of the restored rows into the ring, trash row
zero), so a spill moves between the two rings and the JAX package's.
"""

import logging
from typing import Any

import numpy as np
import torch

from ..config.train_config import TrainConfig
from ..utils.transfer import fetch, upload
from .buffer import ExperienceBuffer

logger = logging.getLogger(__name__)

# Canonical field order of experience row blocks (the names the rollout
# emits for its `mat` / `flush` outputs) and the ring column each fills.
_BLOCK_FIELDS = (
    ("grid", "grid"),
    ("other", "other_features"),
    ("policy", "policy_target"),
    ("ret", "value_target"),
    ("pw", "policy_weight"),
)


def ring_scatter(
    storage: dict[str, torch.Tensor],
    cursor: int,
    blocks: tuple,
    cap: int,
):
    """Flatten + validate + ring-scatter experience blocks, in place.

    Each block holds tensors with arbitrary leading dims (the rollout's
    (T, B) matured and (T, B, n) flushed outputs) plus a boolean `mask`
    over them. Rows are written in block order, leading-dims-major.
    A single ingest larger than the ring keeps only the newest `cap`
    valid rows (`offsets >= count - cap`), so the kept slots are
    distinct; the cursor still advances by the full count. Returns
    (rows written (a 0-d int64 tensor on the ring's device), per-row
    scatter slots, keep mask)."""

    def flat(block, name):
        lead = block["mask"].dim()
        v = block[name]
        return v.reshape((-1,) + tuple(v.shape[lead:]))

    rows = {name: torch.cat([flat(b, name) for b in blocks]) for name, _ in _BLOCK_FIELDS}
    mask = torch.cat([b["mask"].reshape(-1) for b in blocks])
    valid = (
        mask
        & torch.isfinite(rows["grid"]).flatten(1).all(dim=1)
        & torch.isfinite(rows["other"]).all(dim=1)
        & torch.isfinite(rows["policy"]).all(dim=1)
        & torch.isfinite(rows["ret"])
        & ((rows["policy"].sum(dim=1) - 1.0).abs() < 1e-3)
    )
    offsets = torch.cumsum(valid.to(torch.int64), dim=0) - 1
    count = valid.sum()
    keep = valid & (offsets >= count - cap)
    pos = torch.where(keep, (cursor + offsets) % cap, cap)
    for name, column in _BLOCK_FIELDS:
        dst = storage[column]
        dst.index_put_((pos,), rows[name].to(dst.dtype))
    return count, pos, keep


class DeviceReplayBuffer(ExperienceBuffer):
    """PER/uniform replay whose ring lives in the card's memory; the
    host keeps the counters and the SumTree mirror (rl/buffer.py)."""

    is_device = True

    def __init__(
        self,
        config: TrainConfig,
        grid_shape: tuple[int, int, int],
        other_dim: int,
        action_dim: int,
        device,
        seed: "int | None" = None,
        capacity: "int | None" = None,
    ):
        super().__init__(config, seed=seed, action_dim=action_dim, capacity=capacity)
        cap = self.capacity
        self.device = torch.device(device)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self.storage: dict[str, torch.Tensor] = {
            "grid": zeros(cap + 1, *grid_shape, dtype=torch.int8),
            "other_features": zeros(cap + 1, other_dim),
            "policy_target": zeros(cap + 1, action_dim),
            "value_target": zeros(cap + 1),
            "policy_weight": torch.ones(cap + 1, dtype=torch.float32, device=self.device),
        }
        # Ingests this ring ran outside the megastep (rollout chunks and
        # host adds).
        self.dispatch_count = 0

    def record_ingest(self, count: int, max_priority: "float | None" = None) -> np.ndarray:
        """Mirror `count` rows written at the cursor: the SumTree gets
        them at `max_priority` (the tree's watermark when None), then the
        counters advance. Returns their slots."""
        slots = (self._pos + np.arange(count)) % self.capacity
        if self.tree is not None and count:
            p = self.tree.max_priority if max_priority is None else max_priority
            self.tree.update_batch(slots, np.full(count, p, dtype=np.float64))
            self.tree.data_pointer = int((self._pos + count) % self.capacity)
            self.tree.n_entries = min(self._size + count, self.capacity)
        self._pos = int((self._pos + count) % self.capacity)
        self._size = min(self._size + count, self.capacity)
        return slots

    def _ingest_blocks(self, blocks: tuple) -> tuple[int, np.ndarray]:
        """Scatter blocks into the ring; returns (rows written, slots)."""
        count_dev, _, _ = ring_scatter(self.storage, self._pos, blocks, self.capacity)
        self.dispatch_count += 1
        count = int(count_dev)  # the one blocking scalar fetch
        return count, self.record_ingest(count)

    def storage_nbytes(self) -> int:
        """Bytes of the ring's storage on the card, as allocated; equal to
        `telemetry.memory.replay_ring_bytes` of its geometry."""
        from ..telemetry.memory import tree_bytes

        return tree_bytes(self.storage)

    def memory_record(self) -> dict:
        """The ring's `kind: "memory"` ledger record (on the card)."""
        from ..telemetry.memory import replay_ring_record

        return replay_ring_record(self.storage_nbytes(), self.capacity, shards=1, location="device")

    def ingest_payload(self, payload: dict) -> int:
        """Fold one rollout chunk's device-resident experience blocks
        (`SelfPlayEngine.play_moves_device`) into the ring. Returns the
        number of rows written."""
        return self._ingest_blocks((payload["mat"], payload["flush"]))[0]

    def add_dense(
        self,
        grid: np.ndarray,
        other_features: np.ndarray,
        policy_target: np.ndarray,
        value_target: np.ndarray,
        policy_weight: "np.ndarray | None" = None,
    ) -> np.ndarray:
        """Host rows into the ring: one upload, then the ingest's scatter.
        Besides the host ring's finiteness check, the scatter drops rows
        whose policy target is not a distribution. Returns their slots."""
        grid = np.asarray(grid, dtype=np.float32)
        k = grid.shape[0]
        if k == 0:
            return np.zeros(0, dtype=np.int64)
        block = upload(
            {
                "grid": grid,
                "other": np.asarray(other_features, dtype=np.float32),
                "policy": np.asarray(policy_target, dtype=np.float32),
                "ret": np.asarray(value_target, dtype=np.float32).reshape(-1),
                "pw": (
                    np.ones(k, np.float32)
                    if policy_weight is None
                    else np.asarray(policy_weight, dtype=np.float32).reshape(-1)
                ),
                "mask": np.ones(k, bool),
            },
            self.device,
        )
        count, slots = self._ingest_blocks((block,))
        if count < k:
            logger.warning("DeviceReplayBuffer: dropped %d invalid rows of %d on add.", k - count, k)
        return slots.astype(np.int64)

    def sample(self, batch_size: int, current_train_step: "int | None" = None) -> "dict | None":
        """Slot indices and IS weights drawn on the host SumTree (no rows
        move): {"indices", "weights"}, or None until ready. The learner
        gathers the rows on the card."""
        sampled = self._sample_indices(batch_size, current_train_step)
        if sampled is None:
            return None
        slots, weights = sampled
        return {"indices": slots.astype(np.int64), "weights": weights}

    # --- persistence ------------------------------------------------------

    def get_state(self) -> dict[str, Any]:
        """The host ring's snapshot: the `size` rows of every column in one
        bulk device-to-host copy, and their SumTree priorities."""
        state: dict[str, Any] = {
            "pos": self._pos,
            "size": self._size,
            "storage": None,
            "priorities": None,
        }
        if self._size > 0:
            # graftlint: allow(host-sync-in-hot-path) a spill's one fetch of the ring
            state["storage"] = fetch({k: v[: self._size] for k, v in self.storage.items()})
        if self.tree is not None and self._size > 0:
            leaves = np.arange(self._size) + self.tree._cap2
            state["priorities"] = self.tree.tree[leaves].copy()
        return state

    def set_state(self, state: dict[str, Any]) -> None:
        """Restore a snapshot of either ring (or the JAX package's): the
        parent rebuilds the host ring and SumTree, then one upload takes
        the restored rows and, below capacity, one row of the empty
        ring's defaults, which fills the slots past them on the card; the
        trash row stays zero. The upload grows with the rows, not with
        the capacity."""
        super().set_state(state)
        if self._storage is None:
            return
        cap, n = self.capacity, self._size
        rows = upload({k: v[: min(n + 1, cap)] for k, v in self._storage.items()}, self.device)
        for k, dst in self.storage.items():
            dst[:n].copy_(rows[k][:n])
            if n < cap:
                dst[n:cap].copy_(rows[k][n])
            dst[cap].zero_()
        self._storage = None  # the card's ring is the truth
