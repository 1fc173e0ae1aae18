"""Training-loop configuration: counterpart of
`alphatriangle_tpu/config/train_config.py`, field for field, with the
same defaults and validators, so a JAX `model_dump()` loads unchanged.

Every loop mode (synchronous, overlapped, fused megastep) runs, and so
do the checkpoint knobs: `AUTO_RESUME_LATEST`, `LOAD_CHECKPOINT_PATH`
and `LOAD_BUFFER_PATH` are read by `training/runner.py`,
`CHECKPOINT_SAVE_FREQ_STEPS` by the loop. What the port lacks is refused
where it is read (`NORM_TYPE="batch"` training by the learner, Gumbel
root search by the search), so a dumped config of any mode still loads.
`PER_SAMPLE_BACKEND` accepts the JAX mode strings; on a CUDA tensor the
hand-written kernel runs whichever it names (ops/per_sample.py).
"""

import time
from dataclasses import dataclass, field

from ._base import ConfigBase, check_choice, check_range
from .mcts_config import _check_pattern


@dataclass
class TrainConfig(ConfigBase):
    """Training hyperparameters."""

    RUN_NAME: str = field(default_factory=lambda: f"train_{time.strftime('%Y%m%d_%H%M%S')}")
    LOAD_CHECKPOINT_PATH: str | None = None
    LOAD_BUFFER_PATH: str | None = None
    AUTO_RESUME_LATEST: bool = True
    RANDOM_SEED: int = 42

    # --- Loop ---
    MAX_TRAINING_STEPS: int | None = 100_000

    # --- Self-play: games stepped in lockstep on the card ---
    SELF_PLAY_BATCH_SIZE: int = 512
    ROLLOUT_CHUNK_MOVES: int = 16
    NUM_SELF_PLAY_WORKERS: int = 1
    WORKER_UPDATE_FREQ_STEPS: int = 10
    MAX_EPISODE_MOVES: int = 1000
    LEARNER_STEPS_PER_ROLLOUT: int | None = None

    # --- Overlapped (async) orchestration: producer threads behind a
    # replay-ratio gate (training/loop.py) ---
    ASYNC_ROLLOUTS: bool = False
    REPLAY_RATIO: float = 1.0
    ROLLOUT_QUEUE_MAX: int = 4
    PIPELINE_LEARNER: bool = True
    ASYNC_CHUNK_SECONDS: float | None = 2.0
    PRODUCER_MAX_RESTARTS: int = 3
    PRODUCER_RESTART_BACKOFF_S: float = 1.0

    # --- Fused megastep: rollout chunk + ring ingest + PER draw + K
    # learner steps per iteration (rl/megastep.py) ---
    FUSED_MEGASTEP: bool = False

    # --- Batching / buffer ---
    BATCH_SIZE: int = 256
    FUSED_LEARNER_STEPS: int = 1
    BUFFER_CAPACITY: int = 250_000
    MIN_BUFFER_SIZE_TO_TRAIN: int = 25_000
    DEVICE_REPLAY: str = "auto"

    # --- N-step returns ---
    N_STEP_RETURNS: int = 5
    GAMMA: float = 0.99

    # --- Optimizer ---
    OPTIMIZER_TYPE: str = "AdamW"
    LEARNING_RATE: float = 2e-4
    WEIGHT_DECAY: float = 1e-4
    GRADIENT_CLIP_VALUE: float | None = 1.0

    # --- LR schedule ---
    LR_SCHEDULER_TYPE: str | None = "CosineAnnealingLR"
    LR_SCHEDULER_T_MAX: int | None = None
    LR_SCHEDULER_ETA_MIN: float = 1e-6
    LR_SCHEDULER_STEP_SIZE: int = 10_000
    LR_SCHEDULER_GAMMA: float = 0.5

    # --- Loss weights ---
    POLICY_LOSS_WEIGHT: float = 1.0
    VALUE_LOSS_WEIGHT: float = 1.0
    ENTROPY_BONUS_WEIGHT: float = 0.001

    # --- Checkpointing ---
    CHECKPOINT_SAVE_FREQ_STEPS: int = 2500

    # --- PER ---
    USE_PER: bool = True
    PER_ALPHA: float = 0.6
    PER_BETA_INITIAL: float = 0.4
    PER_BETA_FINAL: float = 1.0
    PER_BETA_ANNEAL_STEPS: int | None = None
    PER_EPSILON: float = 1e-5
    PER_SAMPLE_BACKEND: str = "xla"

    # --- Temperature schedule for action selection (move-indexed) ---
    TEMPERATURE_INITIAL: float = 1.0
    TEMPERATURE_FINAL: float = 0.1
    TEMPERATURE_ANNEAL_MOVES: int = 30

    # --- Device / compile (parity stubs, as in the JAX config) ---
    DEVICE: str = "auto"
    WORKER_DEVICE: str = "auto"
    COMPILE_MODEL: bool = True

    # --- Profiling ---
    PROFILE_WORKERS: bool = False

    def __post_init__(self) -> None:
        if self.MAX_TRAINING_STEPS is not None:
            check_range("MAX_TRAINING_STEPS", self.MAX_TRAINING_STEPS, ge=1)
        for name in (
            "SELF_PLAY_BATCH_SIZE", "ROLLOUT_CHUNK_MOVES", "NUM_SELF_PLAY_WORKERS",
            "WORKER_UPDATE_FREQ_STEPS", "MAX_EPISODE_MOVES", "ROLLOUT_QUEUE_MAX",
            "BATCH_SIZE", "FUSED_LEARNER_STEPS", "BUFFER_CAPACITY",
            "MIN_BUFFER_SIZE_TO_TRAIN", "N_STEP_RETURNS", "LR_SCHEDULER_STEP_SIZE",
            "CHECKPOINT_SAVE_FREQ_STEPS", "TEMPERATURE_ANNEAL_MOVES",
        ):
            check_range(name, getattr(self, name), ge=1)
        if self.LEARNER_STEPS_PER_ROLLOUT is not None:
            check_range("LEARNER_STEPS_PER_ROLLOUT", self.LEARNER_STEPS_PER_ROLLOUT, ge=1)
        check_range("REPLAY_RATIO", self.REPLAY_RATIO, gt=0)
        if self.ASYNC_CHUNK_SECONDS is not None:
            check_range("ASYNC_CHUNK_SECONDS", self.ASYNC_CHUNK_SECONDS, gt=0)
        check_range("PRODUCER_MAX_RESTARTS", self.PRODUCER_MAX_RESTARTS, ge=0)
        check_range("PRODUCER_RESTART_BACKOFF_S", self.PRODUCER_RESTART_BACKOFF_S, gt=0)
        check_choice("DEVICE_REPLAY", self.DEVICE_REPLAY, ("auto", "on", "off"))
        check_range("GAMMA", self.GAMMA, gt=0, le=1.0)
        check_choice("OPTIMIZER_TYPE", self.OPTIMIZER_TYPE, ("Adam", "AdamW", "SGD"))
        check_range("LEARNING_RATE", self.LEARNING_RATE, gt=0)
        check_range("WEIGHT_DECAY", self.WEIGHT_DECAY, ge=0)
        check_choice(
            "LR_SCHEDULER_TYPE", self.LR_SCHEDULER_TYPE, ("StepLR", "CosineAnnealingLR", None)
        )
        check_range("LR_SCHEDULER_ETA_MIN", self.LR_SCHEDULER_ETA_MIN, ge=0)
        check_range("LR_SCHEDULER_GAMMA", self.LR_SCHEDULER_GAMMA, gt=0, le=1.0)
        for name in ("POLICY_LOSS_WEIGHT", "VALUE_LOSS_WEIGHT", "ENTROPY_BONUS_WEIGHT"):
            check_range(name, getattr(self, name), ge=0)
        check_range("PER_ALPHA", self.PER_ALPHA, ge=0)
        check_range("PER_BETA_INITIAL", self.PER_BETA_INITIAL, ge=0, le=1.0)
        check_range("PER_BETA_FINAL", self.PER_BETA_FINAL, ge=0, le=1.0)
        check_range("PER_EPSILON", self.PER_EPSILON, gt=0)
        _check_pattern("PER_SAMPLE_BACKEND", self.PER_SAMPLE_BACKEND, "^(xla|pallas)$")
        for name in ("TEMPERATURE_INITIAL", "TEMPERATURE_FINAL"):
            check_range(name, getattr(self, name), ge=0)
        for name in ("DEVICE", "WORKER_DEVICE"):
            check_choice(name, getattr(self, name), ("auto", "tpu", "cpu"))

        # The JAX config's model validators, in their order.
        if self.MIN_BUFFER_SIZE_TO_TRAIN > self.BUFFER_CAPACITY:
            raise ValueError("MIN_BUFFER_SIZE_TO_TRAIN cannot be greater than BUFFER_CAPACITY.")
        if self.BATCH_SIZE > self.BUFFER_CAPACITY:
            raise ValueError("BATCH_SIZE cannot be greater than BUFFER_CAPACITY.")
        horizon = self.MAX_TRAINING_STEPS or 100_000
        if self.LR_SCHEDULER_TYPE == "CosineAnnealingLR" and self.LR_SCHEDULER_T_MAX is None:
            self.LR_SCHEDULER_T_MAX = horizon
        if self.USE_PER and self.PER_BETA_ANNEAL_STEPS is None:
            self.PER_BETA_ANNEAL_STEPS = horizon
        if self.LR_SCHEDULER_T_MAX is not None and self.LR_SCHEDULER_T_MAX <= 0:
            raise ValueError("LR_SCHEDULER_T_MAX must be positive if set.")
        if self.PER_BETA_ANNEAL_STEPS is not None and self.PER_BETA_ANNEAL_STEPS <= 0:
            raise ValueError("PER_BETA_ANNEAL_STEPS must be positive if set.")
        if self.GRADIENT_CLIP_VALUE is not None and self.GRADIENT_CLIP_VALUE <= 0:
            raise ValueError("GRADIENT_CLIP_VALUE must be positive if set.")
        if self.FUSED_MEGASTEP and self.ASYNC_ROLLOUTS:
            raise ValueError(
                "FUSED_MEGASTEP and ASYNC_ROLLOUTS are mutually exclusive loop modes "
                "(the megastep already overlaps acting and learning)."
            )
        if self.FUSED_MEGASTEP and self.DEVICE_REPLAY == "off":
            raise ValueError(
                "FUSED_MEGASTEP needs the device-resident replay ring (its sampling "
                "and ingest run on device); set DEVICE_REPLAY to 'auto' or 'on'."
            )
        if self.PER_BETA_FINAL < self.PER_BETA_INITIAL:
            raise ValueError("PER_BETA_FINAL cannot be less than PER_BETA_INITIAL.")
