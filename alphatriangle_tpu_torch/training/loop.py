"""The training loop in fused-megastep mode: counterpart of
`alphatriangle_tpu/training/loop.py` (`_process_rollout`, `_fold_result`,
`_record_step`, `_learner_budget`, `_max_steps_reached`,
`_megastep_ready`, `_run_megastep_mode`).

Warm-up plays rollout chunks into the device ring (no training) until
the ring can produce a batch; then every iteration is one megastep
(`rl/megastep.py`): a rollout chunk, the ring ingest, the PER draw and K
learner steps, with one fetch at its end. The K of the last megastep
shrinks to the remaining `MAX_TRAINING_STEPS` budget. Metrics stay in
memory (`metrics`, `episode_scores`, `timings`); checkpoints,
TensorBoard, telemetry and the stats collector wait for later slices.
"""

import logging
import threading
import time
from enum import Enum

import numpy as np

from .components import TrainingComponents

logger = logging.getLogger(__name__)


class LoopStatus(str, Enum):
    COMPLETED = "completed"
    STOPPED = "stopped"
    ERROR = "error"


class TrainingLoop:
    """Drives warm-up rollouts, then one megastep per iteration."""

    def __init__(self, components: TrainingComponents):
        self.c = components
        self.cfg = components.train_config
        self.stop_event = threading.Event()
        self.status: "LoopStatus | None" = None
        self.global_step = 0
        self.episodes_played = 0
        self.total_simulations = 0
        # Root visits inherited through subtree reuse (0 without it).
        self.total_reused_visits = 0
        self.experiences_added = 0
        self.warmup_chunks = 0
        self.megastep_iterations = 0
        self.metrics: list[dict] = []  # one dict per learner step, with its "step"
        self.episode_scores: list[float] = []
        self.episode_lengths: list[int] = []
        self.timings: dict[str, list[float]] = {"warmup_chunk_s": [], "megastep_s": []}

    # --- iteration pieces -----------------------------------------------

    def _process_rollout(self) -> int:
        """One warm-up chunk into the device ring; returns rows added."""
        result, payload = self.c.self_play.play_moves_device(self.cfg.ROLLOUT_CHUNK_MOVES)
        return self._fold_result(result, payload=payload)

    def _fold_result(self, result, payload=None, added=None) -> int:
        """Fold one harvest's stats (and, in warm-up, its device payload)
        into the ring and the counters. `added` is the megastep's count:
        its rows were scattered in the megastep itself."""
        if added is None:
            added = self.c.buffer.ingest_payload(payload)
        self.episodes_played += result.num_episodes
        self.total_simulations += result.total_simulations
        self.total_reused_visits += result.total_reused_visits
        self.episode_scores.extend(result.episode_scores)
        self.episode_lengths.extend(result.episode_lengths)
        self.experiences_added += added
        return added

    def _record_step(self, metrics: dict, step: int) -> None:
        """Per-learner-step bookkeeping (the megastep runner already
        reconciled the PER mirror)."""
        self.global_step = step
        record = dict(metrics, step=step)
        if self.cfg.USE_PER:
            record["per_beta"] = self.c.buffer.beta(step)
        self.metrics.append(record)

    def _learner_budget(self, allowed: int) -> int:
        """Steps still allowed: `allowed` capped by MAX_TRAINING_STEPS."""
        if self.cfg.MAX_TRAINING_STEPS is None:
            return allowed
        return min(allowed, self.cfg.MAX_TRAINING_STEPS - self.global_step)

    def _max_steps_reached(self) -> bool:
        max_steps = self.cfg.MAX_TRAINING_STEPS
        return max_steps is not None and self.global_step >= max_steps

    def _megastep_ready(self, need: int) -> bool:
        """Warm-up exit test: the ring can produce a training batch."""
        return len(self.c.buffer) >= need

    # --- main loop --------------------------------------------------------

    def run(self) -> LoopStatus:
        """Run until MAX_TRAINING_STEPS, a stop request or an error."""
        status = LoopStatus.COMPLETED
        try:
            self._run_megastep_mode()
        except KeyboardInterrupt:
            logger.warning("Interrupted.")
            status = LoopStatus.STOPPED
        except Exception:
            logger.exception("Training loop error.")
            status = LoopStatus.ERROR
        finally:
            self.stop_event.set()
        self.status = status
        return status

    def _run_megastep_mode(self) -> None:
        cfg = self.cfg
        runner = self.c.megastep
        need = max(cfg.MIN_BUFFER_SIZE_TO_TRAIN, cfg.BATCH_SIZE)
        while not self.stop_event.is_set() and not self._megastep_ready(need):
            t0 = time.perf_counter()
            self._process_rollout()
            self.timings["warmup_chunk_s"].append(time.perf_counter() - t0)
            self.warmup_chunks += 1
        # Device priorities pick up everything the warm-up wrote into the
        # host mirror.
        runner.sync_priorities_from_host()
        while not self.stop_event.is_set():
            if self._max_steps_reached():
                logger.info("Reached MAX_TRAINING_STEPS=%d.", cfg.MAX_TRAINING_STEPS)
                break
            k = self._learner_budget(runner.steps_per_megastep)
            if k <= 0:
                break
            prev_step = self.global_step
            t0 = time.perf_counter()
            outs, added = runner.run_megastep(cfg.ROLLOUT_CHUNK_MOVES, k)
            self.timings["megastep_s"].append(time.perf_counter() - t0)
            self.megastep_iterations += 1
            self._fold_result(self.c.self_play.harvest(), added=added)
            for i, (metrics, _td) in enumerate(outs):
                self._record_step(metrics, prev_step + i + 1)

    # --- report -----------------------------------------------------------

    def report(self) -> dict:
        """One JSON-ready summary of the run."""
        losses = {
            key: [m[key] for m in self.metrics]
            for key in ("total_loss", "policy_loss", "value_loss", "entropy", "grad_norm")
        }
        mega = self.timings["megastep_s"]
        moves = self.cfg.ROLLOUT_CHUNK_MOVES
        return {
            "status": None if self.status is None else self.status.value,
            "device": str(self.c.device),
            "steps": self.global_step,
            "megasteps": self.megastep_iterations,
            "warmup_chunks": self.warmup_chunks,
            "rows_ingested": self.experiences_added,
            "buffer_size": len(self.c.buffer),
            "episodes": self.episodes_played,
            "simulations": self.total_simulations,
            "reused_visits": self.total_reused_visits,
            "mean_episode_score": (
                float(np.mean(self.episode_scores)) if self.episode_scores else None
            ),
            "losses": losses,
            "timings": {
                "warmup_s": float(sum(self.timings["warmup_chunk_s"])),
                "megastep_s": mega,
                "megastep_s_p50": float(np.median(mega)) if mega else None,
                # Over the whole of the megasteps' time, learner steps included.
                "megastep_moves_per_s": (
                    moves * len(mega) * self.c.self_play.batch_size / sum(mega) if mega else None
                ),
                "learner_steps_per_s": len(self.metrics) / sum(mega) if mega else None,
            },
        }
