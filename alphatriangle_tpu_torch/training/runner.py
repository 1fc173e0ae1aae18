"""Top-level `run_training`: counterpart of
`alphatriangle_tpu/training/runner.py::run_training`, in every loop
mode the config selects (synchronous unless `ASYNC_ROLLOUTS` or
`FUSED_MEGASTEP`).

Resolves auto-resume (`AUTO_RESUME_LATEST`: the newest run under the
persistence root with a committed checkpoint, when it is not this run
already), builds the components (`setup.py`), restores the learner, the
counters and the replay ring (`LOAD_CHECKPOINT_PATH`, else the run's
newest valid checkpoint and the spill at or before it; then
`LOAD_BUFFER_PATH`), installs a SIGTERM handler that preempts the loop
(main thread only), and runs the loop, which saves on its cadences and
once more at the end. The stats collector is closed on every way out
(its last events flushed). Returns the finished `TrainingLoop` (its
`status`, `metrics` and `report()`); `EXIT_CODES` maps the status to a
process exit code, 114 for a preemption. `log_level` configures the
root logger first (`logging_config.setup_logging`), as the JAX runner
does; `telemetry_config` reaches the run's telemetry. A config the port
cannot run raises ValueError from setup, before anything is built. A
restore that fails ends the run as ERROR before any step: a fresh model
is never trained into a run directory whose state could not be read.
"""

import logging
import signal
import threading
import time

from ..config.env_config import EnvConfig
from ..config.mcts_config import MCTSConfig
from ..config.model_config import ModelConfig
from ..config.persistence_config import PersistenceConfig
from ..config.telemetry_config import TelemetryConfig
from ..config.train_config import TrainConfig
from ..logging_config import setup_logging
from ..stats.persistence import CheckpointManager
from .loop import PREEMPT_EXIT_CODE, LoopStatus, TrainingLoop
from .setup import setup_training_components

logger = logging.getLogger(__name__)

EXIT_CODES = {
    LoopStatus.COMPLETED: 0,
    LoopStatus.STOPPED: 0,
    LoopStatus.ERROR: 1,
    LoopStatus.PREEMPTED: PREEMPT_EXIT_CODE,
}


def _install_preempt_handler(loop: TrainingLoop):
    """Route SIGTERM into `loop.request_preempt()` on the main thread
    (`signal.signal` raises elsewhere, and a caller running the loop in
    a thread keeps its own handling). Returns the undo callback. SIGINT
    keeps its KeyboardInterrupt (STOPPED, exit 0)."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None

    def on_sigterm(signum, frame):
        logger.warning(
            "SIGTERM received: preempting (emergency checkpoint, then exit %d).", PREEMPT_EXIT_CODE
        )
        loop.request_preempt()

    previous = signal.signal(signal.SIGTERM, on_sigterm)
    return lambda: signal.signal(signal.SIGTERM, previous)


def _resolve_auto_resume(
    train_config: TrainConfig, persistence: PersistenceConfig
) -> tuple[TrainConfig, PersistenceConfig]:
    """Point RUN_NAME at the newest checkpointed run when auto-resume is
    on and that run is not this one already."""
    if not train_config.AUTO_RESUME_LATEST:
        return train_config, persistence
    latest = CheckpointManager.find_latest_run(persistence)
    if latest is None or latest == train_config.RUN_NAME:
        return train_config, persistence
    logger.info("Auto-resume: continuing latest run '%s'.", latest)
    return (
        train_config.model_copy(update={"RUN_NAME": latest}),
        persistence.model_copy(update={"RUN_NAME": latest}),
    )


def _restore(loop: TrainingLoop) -> None:
    """Install the checkpointed learner, counters and ring (see module
    docstring); nothing when the run has no checkpoint yet."""
    c = loop.c
    cfg = c.train_config
    if cfg.LOAD_CHECKPOINT_PATH:
        loaded = c.checkpoints.restore_path(cfg.LOAD_CHECKPOINT_PATH)
    else:
        loaded = c.checkpoints.restore(buffer=c.buffer)
    if cfg.LOAD_BUFFER_PATH:
        c.checkpoints.restore_buffer_path(c.buffer, cfg.LOAD_BUFFER_PATH)
    loop.restored_rows = len(c.buffer)
    if loaded.train_state is None:
        return
    c.trainer.set_state(loaded.train_state)
    if c.trainer.model is not c.net.model:
        # Self-play and LiveWeights read the net's weights from the new
        # version on; in megastep mode the module is shared.
        c.trainer.sync_to_network()
    loop.set_initial_state(
        loaded.global_step,
        int(loaded.counters.get("episodes_played", 0)),
        int(loaded.counters.get("total_simulations", 0)),
    )
    loop.weight_updates = int(loaded.counters.get("weight_updates", 0))
    logger.info(
        "Resumed at step %d (%d episodes, buffer %d).",
        loaded.global_step, loop.episodes_played, len(c.buffer),
    )


def run_training(
    train_config: "TrainConfig | None" = None,
    env_config: "EnvConfig | None" = None,
    model_config: "ModelConfig | None" = None,
    mcts_config: "MCTSConfig | None" = None,
    persistence_config: "PersistenceConfig | None" = None,
    device=None,
    use_tensorboard: bool = False,
    telemetry_config: "TelemetryConfig | None" = None,
    log_level: "str | None" = None,
) -> TrainingLoop:
    """Run (or resume) a training session on `device` (CUDA unless
    named), in the run directory `persistence_config` names (default:
    `TrainConfig.RUN_NAME` under `./.alphatriangle_data`);
    `use_tensorboard` and `telemetry_config` as in
    `setup_training_components`; `log_level` (e.g. "INFO") sets up the
    root logger, which is left alone when None."""
    if log_level is not None:
        setup_logging(log_level)
    train_config = train_config or TrainConfig()
    persistence_config = persistence_config or PersistenceConfig(RUN_NAME=train_config.RUN_NAME)
    train_config, persistence_config = _resolve_auto_resume(train_config, persistence_config)
    components = setup_training_components(
        train_config=train_config,
        env_config=env_config,
        model_config=model_config,
        mcts_config=mcts_config,
        persistence_config=persistence_config,
        device=device,
        use_tensorboard=use_tensorboard,
        telemetry_config=telemetry_config,
    )
    loop = TrainingLoop(components)
    try:
        t0 = time.perf_counter()
        try:
            _restore(loop)
        except Exception as exc:
            logger.exception(
                "State restore failed for run '%s'; aborting rather than writing a fresh model "
                "into its run directory.",
                persistence_config.RUN_NAME,
            )
            loop.error, loop.status = exc, LoopStatus.ERROR
            return loop
        loop.restore_s = time.perf_counter() - t0
        undo = _install_preempt_handler(loop)
        try:
            status = loop.run()
        finally:
            undo()
    finally:
        components.stats.close()
    logger.info("Training finished: %s", status.value)
    return loop
