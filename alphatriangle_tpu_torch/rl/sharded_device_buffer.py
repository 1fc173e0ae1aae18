"""The dp-sharded device replay ring: counterpart of
`alphatriangle_tpu/rl/sharded_device_buffer.py`
(`ShardedDeviceReplayBuffer`) with one ring shard per rank.

The JAX ring is one array sharded over the dp axis of a single-process
mesh; here each of the D ranks owns its shard, a device ring of
`cap_local = BUFFER_CAPACITY / D` slots plus its trash row, with its own
cursor and SumTree mirror. The experience path stays device-local as
in JAX: each rank's lanes scatter into its own shard (`ingest_payload`,
`DeviceReplayBuffer`'s scatter over `cap_local`), and each rank samples
its B/D stratum of a batch from its own tree (`sample`) or, inside the
megastep, from its own priority slice (`sample_local`, the `per_sample`
kernel over the shard). The IS weights come back max-normalised over
the GLOBAL batch (an all-reduce MAX, the JAX `pmax`), and the fresh
rows of every shard enter at one global watermark (`max_priority`).

Indices: a rank samples, trains on and updates priorities with its own
local slots. The JAX package's global encoding, `shard * (cap_local +
1) + slot`, is `global_indices`, which comparisons with it use.

Snapshots are global, interchangeable with the host ring, the single-
device ring and the JAX package's spills (`get_state`, `set_state`):
`get_state` gathers every shard's rows, in chronological order within
each shard, shard after shard, to rank 0 (a collective: every rank calls
it; only rank 0 gets the rows); `set_state` takes a global snapshot on
every rank and keeps its stripe of it, the contiguous D-th of the
(padded) rows that the JAX ingest hands that shard, with their
priorities. `add_dense` stripes host rows the same way.
"""

import logging
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..config.mesh_config import Mesh
from ..config.train_config import TrainConfig
from ..ops.per_sample import per_sample
from ..parallel.sharding import all_gather_ints, all_reduce_max_, all_reduce_scalar
from ..utils.sumtree import SumTree
from .device_buffer import DeviceReplayBuffer

logger = logging.getLogger(__name__)


class ShardedDeviceReplayBuffer(DeviceReplayBuffer):
    """PER/uniform replay whose ring shards over the dp ranks."""

    is_sharded = True

    def __init__(
        self,
        config: TrainConfig,
        grid_shape: tuple[int, int, int],
        other_dim: int,
        action_dim: int,
        device,
        mesh: Mesh,
        seed: "int | None" = None,
    ):
        dp = mesh.dp
        if config.BUFFER_CAPACITY % dp != 0:
            raise ValueError(f"BUFFER_CAPACITY={config.BUFFER_CAPACITY} must divide over dp={dp} ring shards.")
        base = config.RANDOM_SEED if seed is None else seed
        super().__init__(
            config, grid_shape, other_dim, action_dim, device,
            seed=base + mesh.dp_index, capacity=config.BUFFER_CAPACITY // dp,
        )
        self.mesh = mesh
        self.dp = dp
        self.rank = mesh.dp_index
        self.cap_local = self.capacity
        self.stride = self.cap_local + 1  # + the shard's trash row
        self.global_capacity = config.BUFFER_CAPACITY

    def global_indices(self, slots: np.ndarray) -> np.ndarray:
        """This shard's local slots in the JAX package's global encoding."""
        return self.rank * self.stride + np.asarray(slots, dtype=np.int64)

    def storage_nbytes(self) -> int:
        """Bytes of every shard's storage (the JAX ring's global array):
        this rank's allocation times the dp shards, all alike;
        `storage_nbytes() // dp` is one card's."""
        return super().storage_nbytes() * self.dp

    def memory_record(self) -> dict:
        """The ring's `kind: "memory"` ledger record (dp-sharded)."""
        from ..telemetry.memory import replay_ring_record

        return replay_ring_record(self.storage_nbytes(), self.global_capacity, shards=self.dp,
                                  location="device")

    def shard_sizes(self) -> list:
        """Every shard's row count, in rank order (a collective)."""
        return [s[0] for s in all_gather_ints([self._size], self.mesh)]

    @property
    def max_priority(self) -> float:
        """The global max-priority watermark over every shard's tree (a
        collective): the megastep's fresh rows enter at it on every shard."""
        local = float(self.tree.max_priority) if self.tree is not None else 1.0
        return all_reduce_scalar(local, self.mesh, op="max")

    # --- sampling ---------------------------------------------------------

    def sample(self, batch_size: int, current_train_step: "int | None" = None) -> "dict | None":
        """This rank's stratum of a `batch_size` batch: B/D local slots
        from its own tree and their IS weights, max-normalised over the
        whole batch. None on every rank unless the ring holds
        MIN_BUFFER_SIZE_TO_TRAIN rows and every shard B/D (one gather of
        the shard sizes decides it for all ranks alike)."""
        if batch_size % self.dp != 0:
            raise ValueError(
                f"BATCH_SIZE={batch_size} must divide over dp={self.dp} for the sharded ring "
                "(each rank gathers B/dp rows)."
            )
        b_local = batch_size // self.dp
        sizes = self.shard_sizes()
        if sum(sizes) < self.min_size_to_train or min(sizes) < b_local:
            return None
        if self.use_per:
            if current_train_step is None:
                raise ValueError("current_train_step is required for PER sampling.")
            slots, priorities = self.tree.sample_batch(b_local, self._rng)
            probs = np.maximum(priorities, 1e-12) / max(self.tree.total_priority, 1e-12)
            weights = (self._size * probs) ** (-self.beta(current_train_step))
            top = all_reduce_scalar(float(weights.max()), self.mesh, op="max")
            weights = (weights / top).astype(np.float32)
        else:
            slots = self._rng.integers(0, self._size, size=b_local)
            weights = np.ones(b_local, dtype=np.float32)
        return {"indices": slots.astype(np.int64), "weights": weights}

    def sample_local(self, priorities: torch.Tensor, size: torch.Tensor, k: int, b_local: int,
                     key: torch.Tensor, beta: float):
        """The shard's (K, B/D) draw inside a megastep: the stratified PER
        draw over its own priority slice (`per_sample`, the hand-written
        count on the card) with UNNORMALISED IS weights, which the
        caller max-normalises over the global batch; uniform:
        floor(u * size) and unit weights."""
        from .. import rng

        if self.use_per:
            idx, probs = per_sample(priorities, self.cap_local, k, b_local, key,
                                    mode=self.config.PER_SAMPLE_BACKEND)
            return idx, (size.to(torch.float32) * probs) ** (-beta)
        u = rng.uniform(key, (k, b_local), device=self.device)
        idx = torch.floor(u * size.to(torch.float32)).long()
        idx = torch.minimum(idx.clamp(min=0), (size - 1).clamp(min=0))
        return idx, torch.ones((k, b_local), dtype=torch.float32, device=self.device)

    def normalize_weights(self, weights: torch.Tensor) -> torch.Tensor:
        """(K, B/D) weights over the max of each step's GLOBAL batch."""
        top = all_reduce_max_(weights.amax(dim=1, keepdim=True).contiguous(), self.mesh)
        return weights / top

    # --- host rows, striped over the shards ---------------------------------

    def _stripe(self, n: int) -> slice:
        """This shard's rows of `n` host rows padded to a multiple of D:
        the contiguous D-th the JAX ingest hands shard `rank`."""
        per = (n + (-n) % self.dp) // self.dp
        return slice(min(self.rank * per, n), min((self.rank + 1) * per, n))

    def add_dense(self, grid, other_features, policy_target, value_target, policy_weight=None) -> np.ndarray:
        """Host rows in the global order; this rank ingests its stripe
        (`_stripe`) into its shard. Returns its local slots."""
        k = len(grid)
        rows = self._stripe(k)
        pw = None if policy_weight is None else np.asarray(policy_weight)[rows]
        return super().add_dense(
            np.asarray(grid)[rows], np.asarray(other_features)[rows], np.asarray(policy_target)[rows],
            np.asarray(value_target).reshape(-1)[rows], policy_weight=pw,
        )

    # --- persistence ------------------------------------------------------

    def local_part(self) -> "dict | None":
        """This shard's valid rows in chronological order (oldest at the
        cursor once the shard has wrapped) and their priorities; None
        when it is empty."""
        if self._size == 0:
            return None
        order = np.arange(self._size)
        if self._size == self.capacity:
            order = np.roll(order, -self._pos)
        rows = torch.from_numpy(order).to(self.device)
        return {
            # graftlint: allow(host-sync-in-hot-path) a spill's fetch of the shard, once per cadence
            "storage": {k: v[rows].cpu().numpy() for k, v in self.storage.items()},
            "priorities": self.tree.tree[order + self.tree._cap2].copy() if self.tree is not None else None,
        }

    def get_state(self) -> dict[str, Any]:
        """The global snapshot on rank 0 (a collective): every shard's
        valid rows in chronological order within the shard, shard after
        shard, unwrapped (`pos` = `size`), with their priorities. Other
        ranks get `size` and no rows."""
        part = self.local_part()
        parts = [part]
        if dist.is_initialized():
            parts = [None] * self.dp if self.rank == 0 else None
            dist.gather_object(part, parts, dst=0)
        parts = [p for p in (parts or []) if p is not None]
        size = sum(len(p["storage"]["value_target"]) for p in parts)
        state: dict[str, Any] = {"pos": size, "size": size, "storage": None, "priorities": None}
        if self.rank != 0 or not parts:
            return state
        state["storage"] = {k: np.concatenate([p["storage"][k] for p in parts]) for k in parts[0]["storage"]}
        if parts[0]["priorities"] is not None:
            state["priorities"] = np.concatenate([p["priorities"] for p in parts])
        return state

    def set_state(self, state: dict[str, Any]) -> None:
        """Restore a global snapshot of any ring kind (every rank passes
        the same one): the newest `BUFFER_CAPACITY` rows in chronological
        order, striped over the shards, with their priorities."""
        storage = state.get("storage")
        if storage is None:
            return
        old_size = int(state["size"])
        order = np.roll(np.arange(old_size), -(int(state["pos"]) % max(old_size, 1)))
        order = order[-min(old_size, self.global_capacity):]
        self._pos = self._size = 0
        if self.tree is not None:
            self.tree = SumTree(self.cap_local)
        pw = storage.get("policy_weight")
        slots = self.add_dense(
            np.asarray(storage["grid"])[order].astype(np.float32),
            np.asarray(storage["other_features"])[order],
            np.asarray(storage["policy_target"])[order],
            np.asarray(storage["value_target"])[order],
            policy_weight=None if pw is None else np.asarray(pw)[order],
        )
        pri = state.get("priorities")
        if pri is not None and self.tree is not None:
            pri = np.asarray(pri, dtype=np.float64)[order][self._stripe(len(order))]
            if len(pri) == len(slots):
                self.tree.update_batch(slots, pri)
            else:
                logger.warning(
                    "Priority snapshot stripe of %d != restored rows %d; keeping max-priority init.",
                    len(pri), len(slots),
                )
