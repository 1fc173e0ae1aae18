"""The training loop: counterpart of `alphatriangle_tpu/training/loop.py`
in its three modes, on one device or as one rank of a process group.

- **Synchronous** (the default): each iteration plays a rollout chunk of
  every lane, folds the harvest into the replay ring (the host ring's
  `add_dense`, or the device ring's ingest), then runs
  `LEARNER_STEPS_PER_ROLLOUT or max(1, round(added / BATCH_SIZE))`
  learner steps in groups of `FUSED_LEARNER_STEPS` (a short tail group
  runs as single steps), each group sampled on the host SumTree.
- **Overlapped** (`ASYNC_ROLLOUTS`): `NUM_SELF_PLAY_WORKERS` producer
  threads (clamped per device) each drive their own engine into a
  bounded queue; the main thread folds the harvests and runs the
  learner behind the `REPLAY_RATIO` gate, pipelined one group ahead
  when `PIPELINE_LEARNER`. A crashed stream respawns with exponential
  backoff; once it has used up `PRODUCER_MAX_RESTARTS`, the run ends
  with its error. Chunks are shortened to `ASYNC_CHUNK_SECONDS` from one
  uncontended measurement taken before the producers start.
- **Fused megastep** (`FUSED_MEGASTEP`): warm-up chunks into the device
  ring until it can produce a batch, then one megastep per iteration
  (`rl/megastep.py`): a rollout chunk, the ring ingest, the PER draw and
  K learner steps with one fetch at the end; the K of the last megastep
  shrinks to the remaining `MAX_TRAINING_STEPS` budget.

Outside megastep mode self-play reads the net's weights, which the
learner replaces every `WORKER_UPDATE_FREQ_STEPS` steps
(`Trainer.sync_to_network`, one sync per group that crosses a
multiple); the megastep's rollout reads the learner's own module, so it
has no sync. Each harvest's staleness (the version clock less its
episodes' mean start version) is kept.

On the card each producer thread runs on a CUDA stream of its own; the
main thread (ring ingest, learner, syncs) runs on the device's current
stream. Hand-overs between them are ordered by events and keep their
tensors alive on the receiving stream (`utils/transfer.py`): an engine's
carry goes to its producer's stream at spawn, a producer's device
payload to the ring ingest, and a sync's weights to the producers
(`LiveWeights.ready`, waited for by the chunk that reads them). Under a
reduced `INFERENCE_PRECISION` every producer's chunk reads the net's one
cast copy of the version it plays (`NeuralNetwork.inference_model`,
cast by the first producer to need it, its `ready` event waited for by
the others); the learner, pipelined or not, trains the f32 module.

Checkpoints follow the JAX loop: at every group boundary of every mode
(after a learner group in the synchronous loop and the unpipelined
overlapped loop, after each megastep, and in the pipelined overlapped
loop once the groups in flight are drained, so the saved parameters
and the step label agree) the loop saves the learner state when the
step crossed a `CHECKPOINT_SAVE_FREQ_STEPS` multiple and spills the
ring when it crossed a `BUFFER_SAVE_FREQ_STEPS` one, counted from the
step the run started or resumed at. `run`'s `finally` forces both. A
preemption (`request_preempt`, which the runner's SIGTERM handler
calls) stops the loop at its next beat; after the forced save it writes
`preempt_report.json` into the run directory and the status is
`PREEMPTED`, whose exit code is `PREEMPT_EXIT_CODE`.

Metrics: every harvest and learner step sends the JAX loop's events,
under its names and steps, to the run's `StatsCollector`
(`components.stats`): `Buffer/Size`, `SelfPlay/*` (with
`SelfPlay/Full_Search_Fraction` under playout-cap randomization),
`Progress/*`, `Loss/*`, `LearningRate`, `PER/Beta` and the overlapped
loop's `System/*` gauges. The collector ticks once per iteration (each
warm-up chunk, megastep, synchronous or overlapped iteration) and once
more at the end. The per-step metrics also stay in memory (`metrics`,
which `report()` reads), as do `episode_scores`, `staleness` and
`timings`.

Telemetry (`components.telemetry`, `telemetry.RunTelemetry`; a default
one for components assembled by hand): `run` starts its watchdogs and
closes it last; every harvest beats `on_rollout`, every learner step
`on_learner_step` with its losses, gradient norm and entropy under the
stats names (the anomaly screen). Every iteration ends in
`_iteration_tail`, as the JAX loop's does: one `kind: "util"` record
from the loop's cumulative counters (`on_util_tick`: episodes, rows,
simulations, reused visits, the ring's size, transfer seconds, program
dispatches, iterations with warm-up chunks counted, and the flight
recorder's sealed dispatch wall, from which the record's
`chip_idle_fraction` is the share of the tick with no dispatch in
flight, not the card's idle share), the heartbeat (`on_tick`), the
collector's tick and, every 10 s, a progress line. Before them the
tail drains the freshest device stat-pack fold (`_drain_device_stats`:
the megastep runner's, else any rollout engine's) into one
`kind: "device_stats"` record (`RunTelemetry.record_device_stats`) and
mirrors its root entropy and occupancy, with the beacons' armed state,
into the util record's `root_visit_entropy`, `tree_occupancy` and
`beacons_armed`.

Profiling (`profiling.ProfileSession`): the loop times its phases under
the JAX loop's names (`rollout`, `sample`, `train`, `weight_sync`,
`checkpoint`, `megastep`, and in the overlapped loop `fold`, `dispatch`
and `enqueue_wait/stream<N>`), each phase also a span of the telemetry
tracer. With `TrainConfig.PROFILE_WORKERS` (`cli train --profile`) the
timers go to the collector as `Profile/<phase>_ms` each iteration and to
`profile_data/phase_timers.json` at the end, and iterations 1-2 run
under a `torch.profiler` window exported into `profile_data/`
(`cli analyze` reads both). A megastep run counts its megasteps there,
not its warm-up chunks, so the window holds megasteps 1-2.

A run over a process group (`components.mesh`; the synchronous loop on
any mesh, the megastep and the overlapped loop on a dp-only one) keeps
its ranks in lockstep: the stop test (a stop, or a preemption, on any
rank stops every rank at the same beat), a rank's own host ring drawing
None, the megastep's warm-up gate ("every shard can fill") and the
synchronous loop's step count (from the iteration's global rows) are
reduced over the ranks; the step clock, the checkpoint cadences and the
stop at MAX_TRAINING_STEPS follow the learner step, which is the same
everywhere. The overlapped loop's beats are lockstep too, though its
producer threads run at each rank's own pace: a beat tests the stop
state its ranks agreed at its start (a stream that used up its restarts
sets the rank's stop event mid-beat, and every rank stops at the next
beat), the replay-ratio gate counts the global rows (the rows each beat
folded, reduced over the row owners), the chunk auto-tune takes the
slowest rank's timed chunk, so every rank's producers play one length,
and each rank's extra streams play its share of their lanes. What is
left to a rank's own timing (how many harvests a beat folds, how long it
waits for one) starts no collective. A rank's own host ring
draws B / dp rows (JAX `training/loop.py:464`), a sharded ring each
rank's stratum of B. Rank 0 alone writes the preemption report. A
rank's counters are its own lanes' (rank 0's also hold a restored run's
totals); the checkpoint and the utilization record take their sum over
the ranks (`_lane_totals`, one gather at those lockstep beats), as the
JAX mesh counts every lane once: the lanes of an mdl line's first rank
(it plays them and broadcasts each harvest to its replicas,
`_shared_rollout`) and the replay rows of a dp row's first rank (every
(mdl, sp) rank of the row holds them); the
iteration's global rows count the same way. After every iteration or
megastep of a multi-rank run the ranks' digests of the whole parameters
are gathered and compared (`_note_replicas`): every replica must hold
the same bits, or the run stops with an error. The events are the
rank's own.
"""

import contextlib
import logging
import os
import queue
import threading
import time
from collections import deque
from enum import Enum

import numpy as np
import torch

from ..parallel.distributed import is_primary
from ..parallel.sharding import (
    MDL,
    SP,
    all_gather_ints,
    all_reduce_scalar,
    line_broadcast_object,
    line_gather_object,
)
from ..profiling import ProfileSession
from ..rl.self_play import SelfPlayEngine, merge_lane_shards
from ..stats.events import RawMetricEvent
from ..telemetry import RunTelemetry
from ..telemetry.device_stats import beacons_armed
from ..telemetry.flight import PREEMPT_EXIT_CODE, PREEMPT_REPORT_FILENAME, write_preempt_report
from ..utils.helpers import format_eta
from ..utils.transfer import hand_off, receive
from .components import TrainingComponents
from .setup import clamp_self_play_workers

logger = logging.getLogger(__name__)


class LoopStatus(str, Enum):
    COMPLETED = "completed"
    STOPPED = "stopped"
    ERROR = "error"
    PREEMPTED = "preempted"  # SIGTERM absorbed: emergency save and spill ran


class TrainingLoop:
    """Drives produce -> buffer -> train -> sync in one of three modes."""

    def __init__(self, components: TrainingComponents):
        self.c = components
        self.cfg = components.train_config
        self.stop_event = threading.Event()
        self._preempt_requested = False
        self.status: "LoopStatus | None" = None
        self.error: "BaseException | None" = None
        self._device_replay = components.buffer.is_device
        # A dp run: every decision that changes how many collectives a
        # rank runs is reduced over the ranks first (`_should_stop`,
        # `_sample_group`, `_megastep_ready`, the synchronous loop's step
        # count), so the ranks stay in lockstep.
        self.mesh = components.mesh
        self._grouped = self.mesh is not None and self.mesh.backend is not None
        self._sharded = bool(getattr(components.buffer, "is_sharded", False))
        # Per megastep or iteration of a dp run: the parameters' digest
        # (`Trainer.param_checksum`), equal on every rank.
        self.param_checksums: list = []
        self.global_step = 0
        self.episodes_played = 0
        self.total_simulations = 0
        # Root visits inherited through subtree reuse (0 without it).
        self.total_reused_visits = 0
        self.lane_moves = 0  # moves played, summed over lanes and streams
        # Moves of every rollout chunk this rank played (any stream, folded
        # or not; the megasteps' excluded): each a search of its lanes.
        self._chunk_moves: list = []
        self.weight_updates = 0
        self.experiences_added = 0
        self._steps_this_run = 0
        # Checkpoint cadences count from the step the run started or
        # resumed at (`set_initial_state`).
        self._cadence_anchor = 0
        self._last_saved_step: "int | None" = None
        self._last_buffer_saved_step: "int | None" = None
        self.resumed_step: "int | None" = None
        self.restore_s: "float | None" = None  # the runner's restore, host seconds
        self.restored_rows: "int | None" = None  # the ring's rows after it
        self.iterations = 0
        self.warmup_chunks = 0
        self.megastep_iterations = 0
        # Overlapped mode: stream supervision, the pipelined learner's
        # groups in flight (oldest first), the shared tuned chunk length.
        self._producer_error: "BaseException | None" = None
        self._producer_failures: "queue.Queue" = queue.Queue()
        self._streams: dict[int, dict] = {}
        self.producer_restarts = 0
        self._inflight: deque = deque()
        self._tune_lock = threading.Lock()
        self._tuned_chunk_moves: "int | None" = None
        self.harvests_by_stream: dict[int, int] = {}
        self.queue_depths: list[int] = []
        # The replay-ratio gate's rows (`_count_gate_rows`) and the
        # rank's own rows it has counted so far.
        self._gate_rows = 0
        self._gate_rows_folded = 0
        # Per learner step: its metrics, with its "step".
        self.metrics: list[dict] = []
        self.episode_scores: list[float] = []
        self.episode_lengths: list[int] = []
        self.staleness: list[float] = []  # per harvest with finished episodes
        # Synchronous mode: rows folded and learner steps run per iteration.
        self.rows_per_iteration: list[int] = []
        self.steps_per_iteration: list[int] = []
        # Host-clock seconds: per warm-up chunk and megastep; per
        # iteration with its rollout and learner parts (synchronous
        # mode); per chunk a producer played (overlapped mode, any
        # stream; list.append is atomic).
        self.timings: dict[str, list[float]] = {
            "warmup_chunk_s": [], "megastep_s": [], "iteration_s": [], "rollout_s": [],
            "learner_s": [], "producer_chunk_s": [],
        }
        self.run_s: "float | None" = None
        self.first_megastep_unix: "float | None" = None  # wall clock at the first megastep's end
        self.first_iteration_unix: "float | None" = None  # at the first synchronous iteration's end
        self._last_progress_time = time.monotonic()
        self._last_progress_step = 0
        self.telemetry = components.telemetry or RunTelemetry(
            components.telemetry_config,
            run_dir=components.persistence_config.get_run_base_dir(),
            stats=components.stats,
            run_name=components.persistence_config.RUN_NAME,
        )
        components.telemetry = self.telemetry
        # Components assembled by hand skip setup's flight attach.
        for part in (components.self_play, components.trainer, components.megastep):
            if part is not None and getattr(part, "flight", None) is None:
                part.flight = self.telemetry.flight
        # The phase timers always run; the trace window, the metrics and
        # the dump only under PROFILE_WORKERS.
        self.profile = ProfileSession(
            enabled=self.cfg.PROFILE_WORKERS,
            profile_dir=components.persistence_config.get_profile_dir(),
            tracer=self.telemetry.tracer,
        )
        if self.cfg.FUSED_LEARNER_STEPS > self.cfg.WORKER_UPDATE_FREQ_STEPS:
            logger.warning(
                "FUSED_LEARNER_STEPS=%d > WORKER_UPDATE_FREQ_STEPS=%d: weights can only "
                "sync at group boundaries, so the effective sync cadence is the group size.",
                self.cfg.FUSED_LEARNER_STEPS,
                self.cfg.WORKER_UPDATE_FREQ_STEPS,
            )

    # --- preemption and resume ------------------------------------------

    def request_preempt(self) -> None:
        """Stop for a preemption (SIGTERM): every mode checks `stop_event`
        each beat, so the loop falls through to `run`'s forced save and
        spill, then reports PREEMPTED. Safe in a signal handler (a flag
        and an Event.set)."""
        self._preempt_requested = True
        self.stop_event.set()

    def _write_preempt_report(self) -> None:
        """`preempt_report.json` in the run directory (tmp + os.replace),
        written after the emergency save, so `checkpointed_step` is the
        step a restart resumes from. A failed write is logged: the exit
        code still tells the preemption. In a dp run rank 0 writes it."""
        if not is_primary():
            return
        write_preempt_report(
            self.c.persistence_config.get_run_base_dir() / PREEMPT_REPORT_FILENAME,
            {
                "kind": "preempt",
                "time": time.time(),
                "pid": os.getpid(),
                "step": self.global_step,
                "checkpointed_step": self._last_saved_step,
                "exit_code": PREEMPT_EXIT_CODE,
            },
        )

    def set_initial_state(self, global_step: int, episodes_played: int, total_simulations: int) -> None:
        """Install a restored run's counters; the save cadences count on
        from `global_step`. In a dp run rank 0 alone carries the restored
        totals, so the ranks' sum (`_lane_totals`) is the run's."""
        primary = is_primary()
        self.global_step = global_step
        self.episodes_played = episodes_played if primary else 0
        self.total_simulations = total_simulations if primary else 0
        self._cadence_anchor = global_step
        self.resumed_step = global_step

    # --- iteration pieces -----------------------------------------------

    def _play_rollout(self, engine: SelfPlayEngine, moves: int) -> tuple:
        """One rollout chunk on `engine`: (harvest, device payload or None)."""
        self._chunk_moves.append(moves)  # any thread: list.append is atomic
        if self._device_replay:
            return engine.play_moves_device(moves)
        return engine.play_moves(moves), None

    def _process_rollout(self) -> int:
        """One rollout chunk of the primary engine into the ring; returns
        the rows added."""
        if self.mesh is not None and (self.mesh.mdl > 1 or self.mesh.sp > 1):
            return self._fold_result(*self._shared_rollout())
        result, payload = self._play_rollout(self.c.self_play, self.cfg.ROLLOUT_CHUNK_MOVES)
        return self._fold_result(result, payload=payload)

    def _shared_rollout(self) -> tuple:
        """One rollout chunk on a mesh with mdl or sp replicas: (harvest,
        trace), the harvest's rows its dp row's. The first rank of the
        mdl line plays its lanes and broadcasts the harvest (its mdl
        replicas would play the same lanes with the same keys); the sp
        line then merges its ranks' rows in the dp row's lane order, so
        every rank of a dp row ingests the rows of the (dp, sp = 1) run
        in that run's order. The episode and search counts stay the
        rank's lanes' (`_lane_totals` counts the lanes' owners)."""
        played = None
        if self.mesh.mdl_index == 0:
            engine = self.c.self_play
            self._chunk_moves.append(self.cfg.ROLLOUT_CHUNK_MOVES)
            played = (engine.play_moves(self.cfg.ROLLOUT_CHUNK_MOVES), engine.last_trace)
        result, trace = line_broadcast_object(played, self.mesh, MDL)
        parts = line_gather_object(result, self.mesh, SP)
        return merge_lane_shards(parts, self.mesh.sp_index), trace

    def _fold_result(
        self, result, trace=None, payload=None, ready=None, stream=None, added=None
    ) -> int:
        """Fold one harvest into the ring and the counters. `payload` is
        a device-resident experience block (the device ring ingests it
        after `ready`, the producer's hand-off event); `added` is the
        megastep's row count, whose rows it already scattered; otherwise
        the harvest's rows go to `add_dense`."""
        c = self.c
        if added is not None:
            pass
        elif payload is not None:
            receive(payload, ready)
            added = c.buffer.ingest_payload(payload)
        else:
            c.buffer.add_dense(
                result.grid,
                result.other_features,
                result.policy_target,
                result.value_target,
                policy_weight=result.policy_weight,
            )
            added = result.num_experiences
        self.episodes_played += result.num_episodes
        self.total_simulations += result.total_simulations
        self.total_reused_visits += result.total_reused_visits
        self.episode_scores.extend(result.episode_scores)
        self.episode_lengths.extend(result.episode_lengths)
        step = self.global_step
        events = [
            RawMetricEvent("Buffer/Size", len(c.buffer), step),
            RawMetricEvent("SelfPlay/Experiences_Per_Chunk", added, step),
        ]
        if result.num_episodes:
            clock = self._version_clock()
            self.staleness.append(
                clock - float(np.mean(result.episode_start_versions))
                if result.episode_start_versions
                else clock - result.trainer_step_at_episode_start
            )
            events += [
                RawMetricEvent("SelfPlay/Episode_Score", float(np.mean(result.episode_scores)), step),
                RawMetricEvent("SelfPlay/Episode_Length", float(np.mean(result.episode_lengths)), step),
                RawMetricEvent("Progress/Episodes_Played", self.episodes_played, step),
                RawMetricEvent(
                    "SelfPlay/Truncated_Fraction", result.num_truncated / result.num_episodes, step
                ),
                RawMetricEvent("SelfPlay/Staleness_Steps", self.staleness[-1], step),
            ]
        if trace is None:
            trace = c.self_play.last_trace
        if trace is not None:
            self.lane_moves += int(np.asarray(trace["root_value"]).size)
            events += [
                # Per move, over the simulations that move ran.
                RawMetricEvent(
                    "SelfPlay/Wasted_Slot_Fraction",
                    float(np.mean(trace["wasted_slots"] / np.maximum(trace["sims"][:, None], 1))),
                    step,
                ),
                RawMetricEvent("SelfPlay/Step_Reward", float(np.mean(trace["reward"])), step),
                RawMetricEvent("SelfPlay/Root_Value", float(np.mean(trace["root_value"])), step),
            ]
            if c.self_play.mcts_fast is not None:
                # The achieved full-search rate (target: full_search_prob).
                events.append(
                    RawMetricEvent(
                        "SelfPlay/Full_Search_Fraction", float(np.mean(trace["is_full"])), step
                    )
                )
        c.stats.log_batch_events(events)
        if stream is not None:
            self.harvests_by_stream[stream] = self.harvests_by_stream.get(stream, 0) + 1
        self.experiences_added += added
        self.telemetry.on_rollout(added, result.num_episodes)
        return added

    def _version_clock(self) -> int:
        """The clock staleness is measured on: the net's weights version,
        or the learner step in megastep mode (whose episodes are tagged
        with the live step)."""
        if self.cfg.FUSED_MEGASTEP:
            return self.c.trainer.global_step
        return self.c.net.weights_version

    def _record_step(self, metrics: dict, td_errors, indices, step: int) -> None:
        """Per-learner-step bookkeeping: host priority update (None in
        megastep mode, whose runner reconciled the PER mirror), counters
        and the step's metrics and events. `step` is the step this result
        belongs to: within a group the learner's counter is already at
        the group's end, so each event carries its own x-value."""
        c = self.c
        if indices is not None:
            c.buffer.update_priorities(indices, td_errors)
        self.global_step = step
        self._steps_this_run += 1
        record = dict(metrics, step=step)
        events = [
            RawMetricEvent(f"Loss/{key}", val, step) for key, val in metrics.items() if key.endswith("loss")
        ]
        events += [
            RawMetricEvent("LearningRate", metrics["learning_rate"], step),
            RawMetricEvent("Loss/Entropy", metrics["entropy"], step),
            RawMetricEvent("Loss/Grad_Norm", metrics["grad_norm"], step),
        ]
        if self.cfg.USE_PER:
            record["per_beta"] = c.buffer.beta(step)
            events.append(RawMetricEvent("PER/Beta", record["per_beta"], step))
        c.stats.log_batch_events(events)
        self.metrics.append(record)
        # Liveness beat and the anomaly screen, under the stats names.
        self.telemetry.on_learner_step(
            step,
            {
                **{f"Loss/{key}": val for key, val in metrics.items() if key.endswith("loss")},
                "Loss/Grad_Norm": metrics["grad_norm"],
                "Loss/Entropy": metrics["entropy"],
            },
        )
        if os.environ.get("ALPHATRIANGLE_FAULTS"):
            # The chaos drills' step site (supervise/faults.py: sigterm,
            # sigkill, crash at step N), once the step's bookkeeping is
            # done; every loop mode records its steps here.
            from ..supervise.faults import fault_point

            fault_point("step", step)

    def _should_stop(self) -> bool:
        """The stop test of every loop beat. In a dp run one reduction
        over the ranks: a stop (or a preemption) on any rank stops them
        all at the same beat, the preemption included."""
        if not self._grouped:
            return self.stop_event.is_set()
        code = 2 if self._preempt_requested else 1 if self.stop_event.is_set() else 0
        code = int(all_reduce_scalar(code, self.mesh, op="max"))
        if code == 2:
            self._preempt_requested = True
        if code:
            self.stop_event.set()
        return code > 0

    def _crossed(self, step: int, freq: int, last: "int | None") -> bool:
        """Did `step` cross a `freq` multiple since `last`? (Steps may
        advance by a whole group per call.)"""
        anchor = last if last is not None else self._cadence_anchor
        return step > 0 and step // freq > anchor // freq

    def _ckpt_save_due(self, force: bool = False) -> bool:
        return force or self._crossed(
            self.global_step, self.cfg.CHECKPOINT_SAVE_FREQ_STEPS, self._last_saved_step
        )

    def _buffer_save_due(self, force: bool = False) -> bool:
        persistence = self.c.persistence_config
        return persistence.SAVE_BUFFER and (
            force
            or self._crossed(
                self.global_step, persistence.BUFFER_SAVE_FREQ_STEPS, self._last_buffer_saved_step
            )
        )

    def _checkpoint_due(self) -> bool:
        """Either save cadence pending? The pipelined learner drains its
        groups in flight first whenever this holds."""
        return self._ckpt_save_due() or self._buffer_save_due()

    def _maybe_checkpoint(self, force: bool = False) -> None:
        """Save the learner state and spill the ring when their cadences
        are due (`force`: both, the learner state unless this step is
        saved already)."""
        c = self.c
        step = self.global_step
        if self._ckpt_save_due(force) and self._last_saved_step != step:
            self._last_saved_step = step
            episodes, simulations, _, _ = self._lane_totals()
            c.checkpoints.save(
                step,
                c.trainer.get_state(),
                counters={
                    "episodes_played": episodes,
                    "total_simulations": simulations,
                    "weight_updates": self.weight_updates,
                },
            )
        # On force, always spill: harvests folded after a cadence spill
        # at this same step (the overlapped loop's shutdown) are kept.
        if self._buffer_save_due(force) and (force or self._last_buffer_saved_step != step):
            self._last_buffer_saved_step = step
            c.checkpoints.save_buffer(step, c.buffer)

    def _maybe_sync_weights(self, prev_step: int) -> None:
        """Install the learner's weights in the net when (prev_step,
        global_step] crossed a WORKER_UPDATE_FREQ_STEPS multiple: once,
        however many multiples the group crossed."""
        if self._crossed(self.global_step, self.cfg.WORKER_UPDATE_FREQ_STEPS, prev_step):
            with self.profile.phase("weight_sync"):
                self.c.trainer.sync_to_network()
            self.weight_updates += 1
            self.c.stats.log_scalar(
                "Progress/Weight_Updates_Total", self.weight_updates, self.global_step
            )

    def _learner_budget(self, allowed: int) -> int:
        """Steps the learner may still dispatch: `allowed` capped by
        MAX_TRAINING_STEPS, counting the steps in flight."""
        if self.cfg.MAX_TRAINING_STEPS is None:
            return allowed
        return min(
            allowed, self.cfg.MAX_TRAINING_STEPS - self.global_step - self._inflight_steps()
        )

    def _max_steps_reached(self) -> bool:
        max_steps = self.cfg.MAX_TRAINING_STEPS
        return max_steps is not None and self.global_step >= max_steps

    def _sample_group(self, group: int) -> list:
        """Up to `group` batches sampled from the ring on the host, at the
        learner's dispatch-time step (PER beta)."""
        samples = []
        # BATCH_SIZE is the global batch: a sharded ring draws each rank's
        # stratum of it; a rank's own host ring draws its B / dp share, as
        # each host of the JAX multi-process run does.
        batch = self.cfg.BATCH_SIZE
        if self._grouped and not self._sharded:
            batch //= self.mesh.dp
        with self.profile.phase("sample"):
            for _ in range(group):
                s = self.c.buffer.sample(batch, current_train_step=self.c.trainer.global_step)
                ok = s is not None
                if self._grouped and not self._sharded:
                    ok = bool(all_reduce_scalar(ok, self.mesh, op="min"))
                if not ok:
                    break
                samples.append(s)
        return samples

    def _begin_groups(self, samples: list) -> list:
        """Dispatch sampled batches: a full group of FUSED_LEARNER_STEPS
        (> 1) as one, anything shorter as single steps. Returns the
        (handle, samples) pairs dispatched."""
        c = self.c
        k = max(1, self.cfg.FUSED_LEARNER_STEPS)
        parts = [samples] if len(samples) == k and k > 1 else [[s] for s in samples]
        groups = []
        for part in parts:
            if self._device_replay:
                handle = c.trainer.train_steps_from_begin(c.buffer, part)
            else:
                handle = c.trainer.train_steps_begin([s["batch"] for s in part])
            if handle is None:
                break
            groups.append((handle, part))
        return groups

    def _run_training_steps(self, max_steps: int) -> int:
        """Up to `max_steps` learner steps in groups of
        FUSED_LEARNER_STEPS; priorities update and the weight-sync cadence
        runs after each group. Returns the steps run."""
        k = max(1, self.cfg.FUSED_LEARNER_STEPS)
        ran = 0
        while ran < max_steps and not self._should_stop():
            budget = self._learner_budget(max_steps - ran)
            if budget <= 0:
                break
            group = min(k, budget)
            samples = self._sample_group(group)
            if not samples:
                break
            prev_step = self.global_step
            outs, used = [], []
            with self.profile.phase("train"):
                for handle, part in self._begin_groups(samples):
                    outs.extend(self.c.trainer.train_steps_finish(handle))
                    used.extend(part)
            if not outs:
                break
            for i, (s, (metrics, td_errors)) in enumerate(zip(used, outs)):
                self._record_step(metrics, td_errors, s["indices"], prev_step + i + 1)
            ran += len(outs)
            self._maybe_sync_weights(prev_step)
            with self.profile.phase("checkpoint"):
                self._maybe_checkpoint()
            if len(outs) < group:
                break
        return ran

    # --- the end of every iteration -------------------------------------

    def _engines(self) -> list:
        """Every rollout engine of the run, the primary first, each once."""
        engines = {id(self.c.self_play): self.c.self_play}
        for rec in self._streams.values():
            engine = rec.get("engine")
            if engine is not None:
                engines[id(engine)] = engine
        return list(engines.values())

    def _transfer_seconds(self) -> tuple[float, float]:
        """Cumulative host<->device transfer seconds, (h2d, d2h): the
        learner's batch uploads; the learner's fetches, every engine's
        chunk fetches and the megasteps' fetch."""
        c = self.c
        h2d = float(c.trainer.transfer_h2d_seconds)
        d2h = float(c.trainer.transfer_d2h_seconds)
        d2h += sum(float(e.transfer_d2h_seconds) for e in self._engines())
        if c.megastep is not None:
            d2h += float(c.megastep.transfer_d2h_seconds)
        return h2d, d2h

    def _total_dispatches(self) -> int:
        """Cumulative program dispatches, counted as the JAX loop counts
        them: rollout chunks of every engine, learner groups, ring
        ingests and megasteps (not kernels)."""
        c = self.c
        total = int(c.trainer.dispatch_count) + int(getattr(c.buffer, "dispatch_count", 0))
        total += sum(int(e.dispatch_count) for e in self._engines())
        if c.megastep is not None:
            total += int(c.megastep.dispatch_count)
        return total

    def _drain_device_stats(self) -> "dict | None":
        """The freshest stat-pack fold: the megastep runner's, else the
        primary engine's, else another stream's. Taken once: the source
        is cleared, so an idle iteration ledgers nothing stale."""
        sources = [self.c.megastep] if self.c.megastep is not None else []
        sources += self._engines()
        for src in sources:
            ds = getattr(src, "last_device_stats", None)
            if ds:
                src.last_device_stats = None
                return ds
        return None

    def _iteration_tail(self, warmup: bool = False) -> None:
        """Count the iteration (a megastep warm-up chunk as such), then
        the profile metrics, the device-stats record, the utilization
        record, the heartbeat, the collector's tick and the progress
        line, in the JAX loop's order."""
        if self.cfg.PROFILE_WORKERS:
            for name, val in self.profile.timers.metrics().items():
                self.c.stats.log_scalar(name, val, self.global_step)
        if warmup:
            self.warmup_chunks += 1
        else:
            self.iterations += 1
        telemetry = self.telemetry
        ds = self._drain_device_stats()
        extra = None
        if ds:
            telemetry.record_device_stats(self.global_step, **ds)
            search = ds.get("search") or {}
            extra = {"beacons_armed": int(beacons_armed())}
            if search.get("root_entropy") is not None:
                extra["root_visit_entropy"] = search["root_entropy"]
            if search.get("occupancy") is not None:
                extra["tree_occupancy"] = search["occupancy"]
        h2d, d2h = self._transfer_seconds()
        episodes, simulations, experiences, reused = self._lane_totals()
        telemetry.on_util_tick(
            self.global_step,
            episodes=episodes,
            experiences=experiences,
            simulations=simulations,
            reused_visits=reused,
            buffer_size=len(self.c.buffer),
            transfer_h2d_s=h2d,
            transfer_d2h_s=d2h,
            dispatches=self._total_dispatches(),
            # The JAX loop counts its warm-up chunks as iterations.
            iterations=self.iterations + self.warmup_chunks,
            # The union of the open brackets: the overlapped loop's streams
            # and learner groups are in flight at the same time.
            dispatch_wall_s=telemetry.flight.inflight_wall_s() if telemetry.flight is not None else None,
            extra=extra,
        )
        telemetry.on_tick(self.global_step, len(self.c.buffer))
        self.c.stats.process_and_log(self.global_step)
        self._log_progress()

    def _lane_totals(self) -> tuple:
        """(episodes, simulations, rows, reused visits) over every lane
        once: one gather of the ranks' counters in a multi-rank run
        (every rank calls it at the same beat), each counted on the
        ranks that own it (`Mesh.lane_owner`, `Mesh.row_owner`); the
        loop's own counters otherwise."""
        own = (self.episodes_played, self.total_simulations, self.experiences_added,
               self.total_reused_visits)
        if not self._grouped:
            return own
        lanes, rows = int(self.mesh.lane_owner), int(self.mesh.row_owner)
        own = tuple(v * w for v, w in zip(own, (lanes, lanes, rows, lanes)))
        return tuple(sum(col) for col in zip(*all_gather_ints(own, self.mesh)))

    def _log_progress(self) -> None:
        """At most every 10 s: step, rate, ring, episodes and the ETA."""
        now = time.monotonic()
        elapsed = now - self._last_progress_time
        if elapsed < 10.0:
            return
        steps = self.global_step - self._last_progress_step
        rate = steps / elapsed if elapsed > 0 else 0.0
        max_steps = self.cfg.MAX_TRAINING_STEPS
        eta = format_eta((max_steps - self.global_step) / rate) if rate > 0 and max_steps else "?"
        logger.info(
            "step %d/%s | %.2f steps/s | buffer %d | episodes %d | ETA %s",
            self.global_step, max_steps, rate, len(self.c.buffer), self.episodes_played, eta,
        )
        self._last_progress_time = now
        self._last_progress_step = self.global_step

    # --- main loop --------------------------------------------------------

    def run(self) -> LoopStatus:
        """Run until MAX_TRAINING_STEPS, a stop request or an error. The
        telemetry's close comes last, so the final heartbeat covers the
        forced save; a close that raises ends the run as ERROR."""
        status = LoopStatus.COMPLETED
        t0 = time.perf_counter()
        self.telemetry.start()
        try:
            if self.cfg.FUSED_MEGASTEP:
                self._run_megastep_mode()
            elif self.cfg.ASYNC_ROLLOUTS:
                self._run_async()
            else:
                self._run_sync()
        except KeyboardInterrupt:
            logger.warning("Interrupted.")
            status = LoopStatus.STOPPED
        except Exception as exc:
            logger.exception("Training loop error.")
            self.error = exc
            status = LoopStatus.ERROR
        finally:
            self.stop_event.set()
            try:
                self.profile.close()
                self._maybe_checkpoint(force=True)
                self.c.stats.force_process_and_log(self.global_step)
            except Exception as exc:
                logger.exception("Final save failed.")
                self.error = self.error or exc
                status = LoopStatus.ERROR
            if self._preempt_requested:
                if status is not LoopStatus.ERROR:
                    status = LoopStatus.PREEMPTED
                self._write_preempt_report()
                logger.warning(
                    "Preempted at step %d (emergency checkpoint at step %s); exiting for restart.",
                    self.global_step, self._last_saved_step,
                )
            try:
                self.telemetry.close(self.global_step)
            except Exception as exc:
                logger.exception("Telemetry shutdown failed.")
                self.error = self.error or exc
                status = LoopStatus.ERROR
        self.run_s = time.perf_counter() - t0
        self.status = status
        return status

    def _run_sync(self) -> None:
        cfg = self.cfg
        iteration = 0
        while not self._should_stop():
            if self._max_steps_reached():
                logger.info("Reached MAX_TRAINING_STEPS=%d.", cfg.MAX_TRAINING_STEPS)
                break
            self.profile.on_iteration(iteration)
            iteration += 1
            t0 = time.perf_counter()
            with self.profile.phase("rollout"):
                added = self._process_rollout()
            t1 = time.perf_counter()
            # The global rows of the iteration (each dp row's once) set
            # every rank's step count.
            if self._grouped:
                rows = int(all_reduce_scalar(added if self.mesh.row_owner else 0, self.mesh))
            else:
                rows = added
            n_steps = cfg.LEARNER_STEPS_PER_ROLLOUT or max(1, round(rows / cfg.BATCH_SIZE))
            self.rows_per_iteration.append(added)
            self.steps_per_iteration.append(self._run_training_steps(n_steps))
            self._note_replicas()
            t2 = time.perf_counter()
            self.timings["rollout_s"].append(t1 - t0)
            self.timings["learner_s"].append(t2 - t1)
            self.timings["iteration_s"].append(t2 - t0)
            if self.first_iteration_unix is None:
                self.first_iteration_unix = time.time()
            self._iteration_tail()

    # --- fused megastep ---------------------------------------------------

    def _megastep_ready(self, need: int) -> bool:
        """Warm-up exit test: the ring can produce a training batch. A
        sharded ring needs `need` rows over all shards and every shard
        its B/dp stratum (one gather of the shard sizes, the same answer
        on every rank)."""
        buf = self.c.buffer
        if self._sharded:
            sizes = buf.shard_sizes()
            return sum(sizes) >= need and min(sizes) >= self.cfg.BATCH_SIZE // buf.dp
        return len(buf) >= need

    def _note_replicas(self) -> None:
        """A multi-rank run's digest of the whole parameters after a
        megastep or an iteration, gathered and compared over the ranks
        (every rank calls it): all of them replicas of one model, they
        must agree bit for bit."""
        if self.mesh is None or self.mesh.size == 1:
            return
        digest = self.c.trainer.param_checksum()
        digests = all_gather_ints(digest, self.mesh)
        if len(set(digests)) != 1:
            raise RuntimeError(f"replicas diverged after step {self.global_step}: digests {digests}")
        self.param_checksums.append(digest)

    def _run_megastep_mode(self) -> None:
        cfg = self.cfg
        runner = self.c.megastep
        need = max(cfg.MIN_BUFFER_SIZE_TO_TRAIN, cfg.BATCH_SIZE)
        while not self._should_stop() and not self._megastep_ready(need):
            t0 = time.perf_counter()
            with self.profile.phase("rollout"):
                self._process_rollout()
            self.timings["warmup_chunk_s"].append(time.perf_counter() - t0)
            self._iteration_tail(warmup=True)
        # Device priorities pick up everything the warm-up, and a restore
        # before it, wrote into the host mirror: the first megastep's PER
        # draw reads the restored priorities.
        runner.sync_priorities_from_host()
        # The --profile window counts megasteps: the warm-up stays out.
        iteration = 0
        while not self._should_stop():
            if self._max_steps_reached():
                logger.info("Reached MAX_TRAINING_STEPS=%d.", cfg.MAX_TRAINING_STEPS)
                break
            k = self._learner_budget(runner.steps_per_megastep)
            if k <= 0:
                break
            self.profile.on_iteration(iteration)
            iteration += 1
            prev_step = self.global_step
            t0 = time.perf_counter()
            with self.profile.phase("megastep"):
                outs, added = runner.run_megastep(cfg.ROLLOUT_CHUNK_MOVES, k)
            self.timings["megastep_s"].append(time.perf_counter() - t0)
            if self.first_megastep_unix is None:
                self.first_megastep_unix = time.time()
            self.megastep_iterations += 1
            self._fold_result(self.c.self_play.harvest(), added=added)
            for i, (metrics, td_errors) in enumerate(outs):
                self._record_step(metrics, td_errors, None, prev_step + i + 1)
            self._note_replicas()
            with self.profile.phase("checkpoint"):
                self._maybe_checkpoint()
            self._iteration_tail()

    # --- overlapped producer/consumer -----------------------------------

    def _producer_chunk_moves(self) -> int:
        """Moves per producer chunk: the tuned length, or the configured."""
        with self._tune_lock:
            if self._tuned_chunk_moves is not None:
                return self._tuned_chunk_moves
        return self.cfg.ROLLOUT_CHUNK_MOVES

    def _maybe_tune_chunk(self, moves: int, dt: float, warmed: bool) -> None:
        """Shorten producer chunks to ASYNC_CHUNK_SECONDS from one clean
        measurement: `moves` moves took `dt` seconds (not `warmed`: the
        first chunk, which also pays the first-use costs, is not used).
        The first measurement wins; the length is shared by all streams."""
        target = self.cfg.ASYNC_CHUNK_SECONDS
        if target is None or not warmed:
            return
        with self._tune_lock:
            if self._tuned_chunk_moves is not None:
                return
            per_move = dt / max(moves, 1)
            tuned = max(1, min(self.cfg.ROLLOUT_CHUNK_MOVES, round(target / per_move)))
            if tuned != moves:
                logger.info(
                    "Async chunk auto-tune: %.2fs/%d moves measured (%.2fs/move) -> "
                    "%d moves/dispatch for the %.1fs target.",
                    dt, moves, per_move, tuned, target,
                )
            self._tuned_chunk_moves = tuned

    def _stream_context(self, stream: int):
        """The producer's CUDA stream as the current one (nothing off CUDA)."""
        cuda_stream = self._streams[stream].get("cuda_stream")
        return torch.cuda.stream(cuda_stream) if cuda_stream is not None else contextlib.nullcontext()

    def _producer_loop(self, engine, out: "queue.Queue", stream: int, ready) -> None:
        """Self-play producer: play chunks on this stream and enqueue
        (harvest, trace, payload, hand-off event, stream). A crash is
        reported to the supervisor (the main thread), unless the run is
        already stopping."""
        try:
            with self._stream_context(stream):
                receive(engine._carry, ready)  # the engine was built or last ran elsewhere
                while not self.stop_event.is_set():
                    t0 = time.perf_counter()
                    with self.profile.phase("rollout"):
                        result, payload = self._play_rollout(engine, self._producer_chunk_moves())
                    self.timings["producer_chunk_s"].append(time.perf_counter() - t0)
                    item = (result, engine.last_trace, payload, hand_off(engine.device), stream)
                    # Back-pressure, timed per stream: a long wait here means
                    # the consumer, not self-play, is the bottleneck.
                    with self.profile.phase(f"enqueue_wait/stream{stream}"):
                        while not self.stop_event.is_set():
                            try:
                                out.put(item, timeout=0.2)
                                break
                            except queue.Full:
                                continue
        except BaseException as exc:
            if not self.stop_event.is_set():
                self._producer_failures.put((stream, exc))

    def _spawn_producer_thread(self, engine, harvests: "queue.Queue", stream: int) -> threading.Thread:
        t = threading.Thread(
            target=self._producer_loop,
            args=(engine, harvests, stream, hand_off(engine.device)),
            name=f"self-play-producer-{stream}",
            daemon=True,
        )
        t.start()
        return t

    def _fresh_stream_engine(self, stream: int, attempt: int) -> SelfPlayEngine:
        """A replacement engine for a crashed stream: a fresh carry and
        key stream, the primary's env, extractor, net and batch size."""
        primary = self.c.self_play
        engine = SelfPlayEngine(
            primary.env,
            primary.extractor,
            primary.net,
            primary.mcts_config,
            primary.config,
            batch_size=primary.batch_size,
            seed=self.cfg.RANDOM_SEED + 2000 + stream * 100 + attempt,
            lanes=primary.lanes,
        )
        engine.flight = primary.flight
        return engine

    def _supervise_producers(self, harvests: "queue.Queue") -> None:
        """Respawn crashed streams with exponential backoff; stop the run
        with the stream's error once it used up PRODUCER_MAX_RESTARTS."""
        now = time.monotonic()
        while True:
            try:
                stream, exc = self._producer_failures.get_nowait()
            except queue.Empty:
                break
            rec = self._streams[stream]
            if rec["restarts"] >= self.cfg.PRODUCER_MAX_RESTARTS:
                logger.error(
                    "Producer stream %d crashed and exhausted its %d restarts; aborting run.",
                    stream, self.cfg.PRODUCER_MAX_RESTARTS,
                )
                self._producer_error = exc
                self.stop_event.set()
                return
            delay = self.cfg.PRODUCER_RESTART_BACKOFF_S * (2 ** rec["restarts"])
            rec["restarts"] += 1
            rec["retry_at"] = now + delay
            logger.warning(
                "Producer stream %d crashed (%s: %s); respawning in %.2fs (restart %d/%d).",
                stream, type(exc).__name__, exc, delay, rec["restarts"],
                self.cfg.PRODUCER_MAX_RESTARTS,
            )
        for stream, rec in self._streams.items():
            if rec["retry_at"] is not None and now >= rec["retry_at"]:
                rec["retry_at"] = None
                rec["engine"] = self._fresh_stream_engine(stream, rec["restarts"])
                rec["thread"] = self._spawn_producer_thread(rec["engine"], harvests, stream)
                self.producer_restarts += 1
                self.c.stats.log_scalar(
                    "System/Producer_Restarts", self.producer_restarts, self.global_step
                )

    def _learner_steps_allowed(self) -> int:
        """Replay-ratio gate: steps the learner may take now, REPLAY_RATIO
        samples per row produced in this run (the global rows of a
        multi-rank run, `_count_gate_rows`), groups in flight counted as
        taken. The same on every rank of a lockstep beat."""
        target = self._gate_rows * self.cfg.REPLAY_RATIO / self.cfg.BATCH_SIZE
        return max(0, int(target) - self._steps_this_run - self._inflight_steps())

    def _count_gate_rows(self) -> None:
        """Add the rows folded since the last call to the gate's count:
        the run's own in one process; in a multi-rank run the global rows
        (each dp row's once, one reduction, so every rank calls it at the
        same beat), the rows the JAX loop's one program counts."""
        new = self.experiences_added - self._gate_rows_folded
        self._gate_rows_folded = self.experiences_added
        if self._grouped:
            new = int(all_reduce_scalar(new if self.mesh.row_owner else 0, self.mesh))
        self._gate_rows += new

    def _stop_seen(self) -> bool:
        """The live stop event, for the overlapped beat's local choices. A
        multi-rank beat keeps the stop state its ranks agreed at its start
        (`_should_stop`): a stream that used up its restarts sets this
        rank's event mid-beat, and a test of it between two collectives
        would leave its peers waiting in the next one."""
        return not self._grouped and self.stop_event.is_set()

    # --- pipelined learner (overlapped mode) ------------------------------

    def _inflight_steps(self) -> int:
        return sum(handle["k"] for handle, _ in self._inflight)

    def _dispatch_learner_group(self, allowed: int) -> bool:
        """Sample and dispatch one group without fetching its results;
        True when a group went out."""
        k = max(1, self.cfg.FUSED_LEARNER_STEPS)
        group = min(k, self._learner_budget(allowed))
        if group <= 0 or self._stop_seen():
            return False
        samples = self._sample_group(group)
        if not samples:
            return False
        with self.profile.phase("dispatch"):
            groups = self._begin_groups(samples)
        self._inflight.extend(groups)
        return bool(groups)

    def _finish_oldest_group(self) -> int:
        """Fetch and record the oldest group in flight. A sync after it
        installs the learner's current weights, which may already include
        the next group: fresher than the step label, never older."""
        handle, samples = self._inflight.popleft()
        with self.profile.phase("train"):
            outs = self.c.trainer.train_steps_finish(handle)
        prev_step = self.global_step
        for i, (s, (metrics, td_errors)) in enumerate(zip(samples, outs)):
            self._record_step(metrics, td_errors, s["indices"], prev_step + i + 1)
        self._maybe_sync_weights(prev_step)
        return len(outs)

    def _drain_learner(self) -> int:
        ran = 0
        while self._inflight:
            ran += self._finish_oldest_group()
        return ran

    def _pump_learner(self, allowed: int) -> int:
        """One pipelined beat: dispatch group N+1, then fetch group N, so
        one group runs on the card while the next is sampled. A due save
        drains the groups in flight first, so the saved parameters and
        the step label agree."""
        dispatched = self._dispatch_learner_group(allowed)
        ran = 0
        while len(self._inflight) >= 2:
            ran += self._finish_oldest_group()
        if self._inflight and not dispatched:
            ran += self._finish_oldest_group()
        if ran and self._checkpoint_due():
            ran += self._drain_learner()
            with self.profile.phase("checkpoint"):
                self._maybe_checkpoint()
        return ran

    def _make_rollout_streams(self) -> list:
        """The primary engine plus NUM_SELF_PLAY_WORKERS - 1 more (own
        carry and seed; the primary's env, extractor, net, flight recorder,
        so every stream's chunks are bracketed, and lanes: a dp rank's
        share of each stream's global lanes, as the JAX streams share the
        primary's mesh), clamped to the device's budget."""
        primary = self.c.self_play
        streams = [primary]
        for i in range(1, clamp_self_play_workers(self.cfg.NUM_SELF_PLAY_WORKERS, self.c.device)):
            engine = SelfPlayEngine(
                primary.env,
                primary.extractor,
                primary.net,
                primary.mcts_config,
                primary.config,
                seed=self.cfg.RANDOM_SEED + 1000 + i,
                lanes=primary.lanes,
            )
            engine.flight = primary.flight
            streams.append(engine)
        return streams

    def _run_async(self) -> None:
        cfg = self.cfg
        harvests: "queue.Queue" = queue.Queue(maxsize=cfg.ROLLOUT_QUEUE_MAX)
        if cfg.ASYNC_CHUNK_SECONDS is not None:
            # Size the producers' chunks from an uncontended measurement,
            # before any producer or learner work exists: chunk 1 pays the
            # first-use costs, chunk 2 is timed (the play only; its fold
            # comes after). Both harvests feed the ring.
            self._process_rollout()
            t0 = time.perf_counter()
            result, payload = self._play_rollout(self.c.self_play, cfg.ROLLOUT_CHUNK_MOVES)
            dt = time.perf_counter() - t0
            self._fold_result(result, payload=payload)
            if self._grouped:
                # One length for every rank's producers, as the JAX mesh
                # runs one program: the slowest rank's measurement.
                dt = all_reduce_scalar(dt, self.mesh, op="max")
            self._maybe_tune_chunk(cfg.ROLLOUT_CHUNK_MOVES, dt, warmed=True)
        cuda = self.c.device.type == "cuda"
        for i, engine in enumerate(self._make_rollout_streams()):
            rec = self._streams.setdefault(i, {"restarts": 0, "retry_at": None})
            if cuda and "cuda_stream" not in rec:
                rec["cuda_stream"] = torch.cuda.Stream(self.c.device)
            rec["engine"] = engine
            rec["thread"] = self._spawn_producer_thread(engine, harvests, i)
        self._count_gate_rows()  # the auto-tune's chunks
        iteration = 0
        try:
            while not self._should_stop():
                if self._max_steps_reached():
                    logger.info("Reached MAX_TRAINING_STEPS=%d.", cfg.MAX_TRAINING_STEPS)
                    break
                self.profile.on_iteration(iteration)
                iteration += 1
                t0 = time.perf_counter()
                self._supervise_producers(harvests)
                # Drain everything available; block briefly only when
                # there is no learner work either.
                folded = 0
                with self.profile.phase("fold"):
                    while True:
                        try:
                            self._fold_result(*harvests.get_nowait())
                            folded += 1
                        except queue.Empty:
                            break
                    if (
                        folded == 0
                        and not self._stop_seen()
                        and (self._learner_steps_allowed() == 0 or not self.c.buffer.is_ready())
                    ):
                        try:
                            self._fold_result(*harvests.get(timeout=0.5))
                            folded += 1
                        except queue.Empty:
                            pass
                self._count_gate_rows()
                if cfg.PIPELINE_LEARNER:
                    steps_ran = self._pump_learner(self._learner_steps_allowed())
                else:
                    steps_ran = self._run_training_steps(self._learner_steps_allowed())
                if steps_ran:
                    self._note_replicas()
                if folded == 0 and steps_ran == 0:
                    # Gate open but no batch yet: do not spin.
                    time.sleep(0.05)
                self.queue_depths.append(harvests.qsize())
                stats = self.c.stats
                stats.log_scalar("System/Rollout_Queue_Depth", self.queue_depths[-1], self.global_step)
                if self._gate_rows:
                    stats.log_scalar(
                        "System/Replay_Ratio_Actual",
                        self._steps_this_run * cfg.BATCH_SIZE / self._gate_rows,
                        self.global_step,
                    )
                self.timings["iteration_s"].append(time.perf_counter() - t0)
                self._iteration_tail()
        finally:
            self.stop_event.set()
            # Land the groups still in flight so their steps are recorded.
            try:
                self._drain_learner()
            except Exception:
                logger.exception("Draining in-flight learner groups failed.")
            for rec in self._streams.values():
                rec["thread"].join(timeout=30.0)
                if rec["thread"].is_alive():
                    logger.warning("%s did not join within 30s.", rec["thread"].name)
            # Fold what is still queued: it was played.
            while True:
                try:
                    self._fold_result(*harvests.get_nowait())
                except queue.Empty:
                    break
            if self._producer_error is not None:
                raise self._producer_error

    # --- report -----------------------------------------------------------

    def report(self) -> dict:
        """One JSON-ready summary of the run."""
        cfg = self.cfg
        mode = "megastep" if cfg.FUSED_MEGASTEP else "async" if cfg.ASYNC_ROLLOUTS else "sync"
        losses = {
            key: [m[key] for m in self.metrics]
            for key in ("total_loss", "policy_loss", "value_loss", "entropy", "grad_norm")
        }
        mega = self.timings["megastep_s"]
        iters = self.timings["iteration_s"]
        moves = cfg.ROLLOUT_CHUNK_MOVES
        run_s = self.run_s
        ckpt = self.c.checkpoints.timings
        return {
            "status": None if self.status is None else self.status.value,
            "error": None if self.error is None else repr(self.error),
            "mode": mode,
            "run_name": self.c.persistence_config.RUN_NAME,
            "run_dir": str(self.c.persistence_config.get_run_base_dir()),
            "resumed_step": self.resumed_step,
            "restore_s": self.restore_s,
            "restored_rows": self.restored_rows,
            "checkpointed_step": self._last_saved_step,
            "buffer_saved_step": self._last_buffer_saved_step,
            "device": str(self.c.device),
            # The mesh: this rank, the world, the axes' sizes and this
            # rank's indices, the process group's backend (None: one
            # process) and the digests per megastep or iteration, which
            # agree over the ranks.
            "dp": {
                "rank": self.mesh.rank if self.mesh is not None else 0,
                "world": self.mesh.size if self.mesh is not None else 1,
                "mesh": {"dp": self.mesh.dp, "mdl": self.mesh.mdl, "sp": self.mesh.sp}
                if self.mesh is not None else {"dp": 1, "mdl": 1, "sp": 1},
                "index": {"dp": self.mesh.dp_index, "mdl": self.mesh.mdl_index,
                          "sp": self.mesh.sp_index}
                if self.mesh is not None else {"dp": 0, "mdl": 0, "sp": 0},
                "backend": self.mesh.backend if self.mesh is not None else None,
                "param_checksums": self.param_checksums,
            },
            "steps": self.global_step,
            "iterations": self.iterations,
            "megasteps": self.megastep_iterations,
            "warmup_chunks": self.warmup_chunks,
            "rows_ingested": self.experiences_added,
            "buffer_size": len(self.c.buffer),
            "replay_ring": "device" if self._device_replay else "host",
            "episodes": self.episodes_played,
            "simulations": self.total_simulations,
            "reused_visits": self.total_reused_visits,
            "lane_moves": self.lane_moves,
            "chunk_moves": sum(self._chunk_moves),
            "weight_updates": self.weight_updates,
            "weights_version": self.c.net.weights_version,
            # Samples consumed per row produced.
            "replay_ratio": (
                self._steps_this_run * cfg.BATCH_SIZE / self.experiences_added
                if self.experiences_added else None
            ),
            "rows_per_iteration": self.rows_per_iteration,
            "steps_per_iteration": self.steps_per_iteration,
            "producer_restarts": self.producer_restarts,
            "harvests_by_stream": self.harvests_by_stream,
            "tuned_chunk_moves": self._tuned_chunk_moves,
            "queue_depth_max": max(self.queue_depths) if self.queue_depths else None,
            "staleness_mean": float(np.mean(self.staleness)) if self.staleness else None,
            "mean_episode_score": (
                float(np.mean(self.episode_scores)) if self.episode_scores else None
            ),
            "losses": losses,
            "timings": {
                "run_s": run_s,
                "warmup_s": float(sum(self.timings["warmup_chunk_s"])),
                "iteration_s_p50": float(np.median(iters)) if iters else None,
                "producer_chunk_s_p50": (
                    float(np.median(self.timings["producer_chunk_s"]))
                    if self.timings["producer_chunk_s"] else None
                ),
                "megastep_s": mega,
                "megastep_s_p50": float(np.median(mega)) if mega else None,
                # Over the whole of the megasteps' time, learner steps included.
                "megastep_moves_per_s": (
                    moves * len(mega) * self.c.self_play.batch_size / sum(mega) if mega else None
                ),
                # Over the whole run's wall, every mode alike.
                "learner_steps_per_s": self.global_step / run_s if run_s else None,
                "lane_moves_per_s": self.lane_moves / run_s if run_s else None,
                "first_iteration_s": iters[0] if iters else (mega[0] if mega else None),
                "first_megastep_unix": self.first_megastep_unix,
                "first_iteration_unix": self.first_iteration_unix,
            },
            # The caching allocator's peak on the run's card (None on the CPU).
            "peak_device_bytes": (
                torch.cuda.max_memory_allocated(self.c.device) if self.c.device.type == "cuda" else None
            ),
            # Host seconds of each save, spill and restore; bytes of each spill.
            "checkpoints": {k: list(v) for k, v in ckpt.items()},
            # The stats collector's writers and live file.
            "stats_writers": self.c.stats.writers,
            "live_metrics": (
                None if self.c.stats.live_path is None else str(self.c.stats.live_path)
            ),
        }
