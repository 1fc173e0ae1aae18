"""Fused megastep: counterpart of `alphatriangle_tpu/rl/megastep.py`
(`MegastepRunner._sample_indices`, `_impl`, `_sharded_impl`,
`_max_priority_watermark`, `sync_priorities_from_host`, `run_megastep`).

One megastep is, on one device and with no host sync between stages:

1. `selfplay.chunk`: a rollout chunk (`SelfPlayEngine._chunk`) searched
   with the learner's live module in eval mode, its batch norms on their
   running statistics (no copy of the weights under float32: episodes
   are tagged with the learner step, zero staleness). Under a reduced
   `INFERENCE_PRECISION` the chunk reads an `InferenceNet` cast from that
   module once per megastep (`selfplay.cast`), as the JAX megastep casts
   inside its program; the K learner steps keep training the float32
   module and its running statistics;
2. `ring.ingest`: `ring_scatter` of the chunk's experience blocks into
   the device ring, and max-priority init of the fresh rows in the
   device priority array (trash slot pinned to 0);
3. `per.sample`: the stratified PER draw of K batches
   (`ops.per_sample`, whose count is the hand-written kernel on the
   card) with beta-annealed, max-normalised importance weights, or a
   uniform draw without PER;
4. `learner.steps`: K learner steps on batches gathered from the ring;
5. `per.update`: the K steps' TD errors written back as priorities in
   step order, duplicates within a step resolved last-write-wins.

Each stage runs under a `torch.profiler.record_function` label of that
name. The outputs (rows added, episode stats, trace, metrics, TD
errors, sampled slots) reach the host in one copy at the end
(`utils.transfer.fetch`), after which the host SumTree mirror replays
the ingest at the same pre-megastep watermark and the TD updates in
the same order. The search itself keeps the host syncs it already had.

The dp megastep (a `ShardedDeviceReplayBuffer`, JAX `_sharded_impl`)
runs the same five stages on every rank: the chunk on the rank's lanes
(the engine's `lanes`), the ingest into its ring shard, the PER draw of
its B/dp stratum over its own priority slice with the sampling key
folded with its dp index (`fold_in(key, shard)`), the IS weights
max-normalised over the GLOBAL batch (an all-reduce MAX, JAX's `pmax`),
K learner steps whose gradients are all-reduced (`rl/trainer.py`) and
the priority write into its slice; the fresh rows of every shard enter
at the global watermark (`ShardedDeviceReplayBuffer.max_priority`).
Indices stay local (`last_idx`); the PER stat leg covers the rank's
shard. The flight program is `megastep/dp<D>_t<T>_k<K>`.

With a run's flight recorder attached (`flight`), each megastep writes
an intent (`megastep/t<T>_k<K>`) before its work is launched and a seal
after that one copy; `transfer_d2h_seconds` counts the host seconds
blocked in the copy, the wait for the card included.

Device stats (the engine's flag, `device_stats`): the chunk's stacked
search stat-packs and a PER stat-pack (`_per_stat_pack`: priority skew
over the live slots and the IS-weight extremes of the K draws, plain
reductions on the card) ride the same copy; the host folds them, with
the rollout leg and the learner leg (the K steps' largest gradient and
update norms, which the learner already returns), into
`last_device_stats`. The megastep's beacon sites are `rollout_chunk`
after the chunk and `ring_scatter` after the ingest, indexed by the
learner step, beside the searches' `search_wave` and the learner's
`learner_step`.
"""

import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import rng
from ..config.train_config import TrainConfig
from ..nn import precision
from ..nn.network import LiveWeights
from ..ops.per_sample import per_sample
from ..telemetry.device_stats import (
    emit_beacon,
    fold_search_stats,
    note_dispatch,
    rollout_chunk_stats,
    unpack_per_stats,
    unpack_search_stats,
)
from ..telemetry.flight import flight_span
from ..telemetry.roofline import megastep_cost, note_program_cost
from ..utils.transfer import fetch
from .device_buffer import DeviceReplayBuffer, ring_scatter


def last_write_slots(idx: torch.Tensor, trash: int) -> torch.Tensor:
    """(B,) slots with every write that a later one in the row repeats
    sent to `trash`, so an `index_put_` keeps exactly the last write of
    each slot (the card gives repeated indices no defined winner)."""
    b = idx.shape[0]
    same = idx[:, None] == idx[None, :]
    later = torch.ones((b, b), dtype=torch.bool, device=idx.device).triu(1)
    overwritten = (same & later).any(dim=1)
    return torch.where(overwritten, trash, idx)


class MegastepRunner:
    """Binds one (engine, trainer, device ring) triple; the training
    loop's megastep mode drives it once per iteration."""

    sharded = False  # the dp megastep (a ShardedDeviceReplayBuffer)

    def __init__(self, engine, trainer, buffer: DeviceReplayBuffer, train_config: TrainConfig):
        if not getattr(buffer, "is_device", False):
            raise ValueError("MegastepRunner needs the device-resident replay ring")
        self.sharded = bool(getattr(buffer, "is_sharded", False))
        if self.sharded:
            # Each rank pairs its lanes with its own ring shard.
            if engine.lanes is None:
                raise ValueError(
                    "Sharded megastep: the self-play engine must step its rank's lanes "
                    "(SelfPlayEngine(lanes=...)) to feed the rank's ring shard"
                )
            if trainer.mesh != buffer.mesh:
                raise ValueError("Sharded megastep: trainer and replay ring must share one mesh.")
            if train_config.BATCH_SIZE % buffer.dp != 0:
                raise ValueError(
                    f"BATCH_SIZE={train_config.BATCH_SIZE} must divide over dp={buffer.dp} "
                    "(each shard samples its B/dp stratum)."
                )
        elif engine.lanes is not None:
            raise ValueError(
                "MegastepRunner with the single-device ring needs a single-device engine; "
                "lane-sharded engines pair with the dp-sharded ring (ShardedDeviceReplayBuffer)."
            )
        if engine.net.model is not trainer.model:
            raise ValueError("the rollout engine must search with the learner's module")
        if not (engine.device == buffer.device == trainer.device):
            raise ValueError(
                f"engine ({engine.device}), ring ({buffer.device}) and learner "
                f"({trainer.device}) must share one device"
            )
        self.engine = engine
        self.trainer = trainer
        self.buffer = buffer
        self.config = train_config
        self.device = buffer.device
        self.batch_size = train_config.BATCH_SIZE
        self.dp = buffer.dp if self.sharded else 1
        self.cap = buffer.capacity  # the rank's shard when sharded
        self.use_per = train_config.USE_PER
        self.per_alpha = float(train_config.PER_ALPHA)
        self.per_epsilon = float(train_config.PER_EPSILON)
        self.beta_initial = float(train_config.PER_BETA_INITIAL)
        self.beta_final = float(train_config.PER_BETA_FINAL)
        self.beta_anneal = float(train_config.PER_BETA_ANNEAL_STEPS or 1)
        self.per_sample_backend = train_config.PER_SAMPLE_BACKEND
        # Learner steps per megastep: LEARNER_STEPS_PER_ROLLOUT pins it.
        self.steps_per_megastep = train_config.LEARNER_STEPS_PER_ROLLOUT or max(
            1, train_config.FUSED_LEARNER_STEPS
        )
        # The device priority array, (cap + 1,) f32 with the trash slot
        # at `cap` pinned to 0: the sampling truth inside a megastep.
        # None until `sync_priorities_from_host` seeds it.
        self._priorities: "torch.Tensor | None" = None
        self.dispatch_count = 0  # megasteps run
        self.transfer_d2h_seconds = 0.0  # host seconds blocked in the megasteps' fetch
        self.flight = None  # the run's flight recorder, when attached
        self.model_config = trainer.nn.model_config
        self.reduced = precision.inference_dtype(self.model_config) != torch.float32
        self.last_idx: "np.ndarray | None" = None  # (K, B) slots of the last draw
        # The engine's stat-pack flag and the newest megastep's folded legs.
        self.device_stats = bool(engine.device_stats)
        self.last_device_stats: "dict | None" = None

    # --- device stages -------------------------------------------------

    def _beta(self, step: int) -> np.float32:
        """Beta on the learner-step clock, in float32 as on the device."""
        f32 = np.float32
        frac = np.clip(f32(step) / f32(self.beta_anneal), f32(0), f32(1))
        return f32(self.beta_initial) + frac * f32(self.beta_final - self.beta_initial)

    def _sample_indices(self, priorities: torch.Tensor, size: torch.Tensor, k: int):
        """(K, B) slots + IS weights, drawn on the device with one key
        split off the learner's key."""
        b = self.batch_size
        keys = rng.split(self.trainer.state.rng)
        self.trainer.state.rng, k_sample = keys[0], keys[1]
        if self.sharded:
            buf = self.buffer
            beta = float(self._beta(self.trainer.state.step)) if self.use_per else 0.0
            idx, w = buf.sample_local(
                priorities, size, k, b // self.dp, rng.fold_in(k_sample, buf.rank), beta
            )
            return idx, (buf.normalize_weights(w) if self.use_per else w)
        if self.use_per:
            idx, probs = per_sample(priorities, self.cap, k, b, k_sample, mode=self.per_sample_backend)
            beta = float(self._beta(self.trainer.state.step))
            w = (size.to(torch.float32) * probs) ** (-beta)
            weights = w / w.amax(dim=1, keepdim=True)
        else:
            u = rng.uniform(k_sample, (k, b), device=self.device)
            idx = torch.floor(u * size.to(torch.float32)).long()
            idx = torch.minimum(idx.clamp(min=0), (size - 1).clamp(min=0))
            weights = torch.ones((k, b), dtype=torch.float32, device=self.device)
        return idx, weights

    @staticmethod
    def _per_stat_pack(priorities: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """The PER leg (`PER_SCALARS`): the priority mass's skew, max over
        the mean of the live slots (empty and trash slots hold exactly
        0), and the extremes of the K draws' IS weights; float64."""
        count = (priorities > 0).sum().clamp(min=1).to(torch.float32)
        mean_live = (priorities.sum() / count).clamp(min=1e-9)
        return torch.stack([priorities.max() / mean_live, weights.min(), weights.max()]).to(torch.float64)

    def _impl(self, num_moves: int, k: int, max_priority: float) -> dict:
        """The five stages; updates engine carry, ring, priorities and
        learner in place and returns the outputs (still on the device)."""
        engine, buf, trainer = self.engine, self.buffer, self.trainer
        model = trainer.model
        if self.reduced:
            with record_function("selfplay.cast"):
                model = precision.InferenceNet(trainer.model, self.model_config)
        with record_function("selfplay.chunk"):
            live = LiveWeights(trainer.state.step, model)
            engine._carry, outs = engine._chunk(num_moves, engine._carry, live)
        emit_beacon("rollout_chunk", trainer.state.step, device=self.device)
        ds_search = outs.pop("device_stats", None)
        with record_function("ring.ingest"):
            count, pos, keep = ring_scatter(
                buf.storage, buf._pos, (outs.pop("mat"), outs.pop("flush")), self.cap
            )
            size = torch.clamp(buf._size + count, max=self.cap)
            if self.use_per:
                self._priorities.index_put_((pos,), torch.where(keep, max_priority, 0.0))
                self._priorities[self.cap] = 0.0
        emit_beacon("ring_scatter", trainer.state.step, device=self.device)
        with record_function("per.sample"):
            idx, weights = self._sample_indices(self._priorities, size, k)
            ds_per = self._per_stat_pack(self._priorities, weights) if self.device_stats else None
        with record_function("learner.steps"):
            # graftlint: allow(use-after-donation) the learner reads the rows this ingest wrote
            metrics_k, td_k = trainer._train_steps_from_impl(buf.storage, idx, weights)
        if self.use_per:
            with record_function("per.update"):
                for j in range(k):
                    prio = (td_k[j].abs() + self.per_epsilon) ** self.per_alpha
                    slots = last_write_slots(idx[j], self.cap)
                    self._priorities.index_put_((slots,), prio.to(torch.float32))
                self._priorities[self.cap] = 0.0
        out = {
            "rows_added": count,
            "episode": outs["episode"],
            "trace": outs["trace"],
            "sentinel_live": outs["sentinel_live"],
            "metrics": metrics_k,
            "td": td_k,
            "idx": idx,
        }
        if self.device_stats:
            out["device_stats"] = {"search": ds_search, "per": ds_per}
        return out

    # --- host API ------------------------------------------------------

    def _max_priority_watermark(self) -> float:
        """The pre-megastep watermark fresh rows enter at; the host
        mirror's reconciliation reuses the same value. Sharded: the
        global one over every shard's tree."""
        if self.sharded:
            return self.buffer.max_priority
        tree = self.buffer.tree
        return float(tree.max_priority) if tree is not None else 1.0

    def sync_priorities_from_host(self) -> None:
        """(Re)seed the device priority array from the host SumTree
        mirror, after warm-up ingests, a restored ring or any other
        host-side write (float32 of the float64 leaves, trash slot 0)."""
        p = np.zeros(self.cap + 1, np.float32)
        tree = self.buffer.tree
        if tree is not None:
            p[: self.cap] = tree.tree[np.arange(self.cap) + tree._cap2]
        self._priorities = torch.from_numpy(p).to(self.device)

    @property
    def priorities(self) -> "torch.Tensor | None":
        return self._priorities

    def run_megastep(self, num_moves: "int | None" = None, k: "int | None" = None):
        """One megastep. Returns (per-step (metrics, TD errors) list, rows
        ingested). Engine carry and episode stats, ring storage and
        counters, the reconciled PER mirror and the learner all advance."""
        t = int(num_moves or self.config.ROLLOUT_CHUNK_MOVES)
        k = int(k or self.steps_per_megastep)
        buf, engine, trainer = self.buffer, self.engine, self.trainer
        if self._priorities is None:
            self.sync_priorities_from_host()
        max_p = self._max_priority_watermark()
        start_step = trainer.state.step
        name = f"megastep/dp{self.dp}_t{t}_k{k}" if self.sharded else f"megastep/t{t}_k{k}"
        note_program_cost(name, lambda: megastep_cost(self, t, k, self.batch_size // self.dp),
                          f"B{self.batch_size}xT{t}xK{k}", self.device.type)
        with flight_span(self.flight, "megastep", name, avals=f"B{self.batch_size}xT{t}xK{k}"):
            note_dispatch(name)
            out = self._impl(t, k, max_p)
            self.dispatch_count += 1
            engine.net.forget_inference_model()  # the module moved in place
            t0 = time.perf_counter()
            # graftlint: allow(host-sync-in-hot-path) the megastep's one fetch
            host = fetch(out)  # the one transfer of the megastep
            self.transfer_d2h_seconds += time.perf_counter() - t0

        # --- host mirror reconciliation ---------------------------------
        count = int(host["rows_added"])
        if count > self.cap:
            raise RuntimeError(
                f"megastep ingested {count} rows into a {self.cap}-slot ring in one "
                "scatter (shrink ROLLOUT_CHUNK_MOVES or grow BUFFER_CAPACITY)"
            )
        buf.record_ingest(count, max_priority=max_p)
        if buf.tree is not None:
            for j in range(k):
                buf.update_priorities(host["idx"][j], host["td"][j])
        self.last_idx = host["idx"]

        # --- engine-side stats: episodes, simulations, reused visits ----
        engine.fold_chunk_stats(host)
        engine.note_weights_version(start_step)
        if self.device_stats:
            ds = host["device_stats"]
            learner = {
                dst: round(float(np.max(host["metrics"][src])), 6)
                for src, dst in (("grad_norm", "grad_norm_max"), ("update_norm", "update_norm_max"))
                if src in host["metrics"]
            }
            self.last_device_stats = {
                "search": fold_search_stats(unpack_search_stats(ds["search"])),
                "rollout": rollout_chunk_stats(host["episode"]["ending"], host["trace"]["reward"]),
                "per": unpack_per_stats(ds["per"]),
                "learner": learner or None,
            }

        # --- learner results --------------------------------------------
        results = []
        for i in range(k):
            m = {key: float(v[i]) for key, v in host["metrics"].items()}
            m["learning_rate"] = float(trainer.schedule(start_step + i + 1))
            results.append((m, np.asarray(host["td"][i])))
        return results, count
