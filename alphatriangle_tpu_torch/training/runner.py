"""Top-level `run_training`: counterpart of
`alphatriangle_tpu/training/runner.py::run_training`, in every loop
mode the config selects (synchronous unless `ASYNC_ROLLOUTS` or
`FUSED_MEGASTEP`).

Applies the recovery overrides a `cli supervise` parent hands its
respawned child (`_apply_supervise_overrides`, the environment's
`ALPHATRIANGLE_SUPERVISE_OVERRIDES`), then resolves auto-resume (`AUTO_RESUME_LATEST`: the newest run under the
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

With a `DistributedConfig` (`cli train --distributed`) the runner joins
the process group before the device is touched
(`parallel.initialize_distributed`, which picks the rank's card), rank
0 resolves auto-resume and broadcasts the run name, setup builds the
mesh (`mesh_config`: dp, and the mdl and sp axes, which no CLI flag
sets), and a restore is read on rank 0 (learner state, counters,
spill) and broadcast: every rank installs the same whole learner state
and takes its mdl shards of it, and a sharded ring keeps its stripe of
the spill. Ranks but the first open
no TensorBoard writer. The runner leaves the group when the run ends.
"""

import json
import logging
import os
import signal
import threading
import time

from ..config.env_config import EnvConfig
from ..config.mesh_config import MeshConfig
from ..config.mcts_config import MCTSConfig
from ..config.model_config import ModelConfig
from ..config.persistence_config import PersistenceConfig
from ..config.telemetry_config import TelemetryConfig
from ..config.train_config import TrainConfig
from ..logging_config import setup_logging
from ..parallel.distributed import (
    DistributedConfig,
    initialize_distributed,
    is_primary,
    rank_device,
    shutdown_distributed,
)
from ..parallel.sharding import broadcast_object
from ..stats.persistence import CheckpointManager
from ..supervise.supervisor import OVERRIDES_ENV
from .loop import PREEMPT_EXIT_CODE, LoopStatus, TrainingLoop
from .setup import setup_training_components

logger = logging.getLogger(__name__)

EXIT_CODES = {
    LoopStatus.COMPLETED: 0,
    LoopStatus.STOPPED: 0,
    LoopStatus.ERROR: 1,
    LoopStatus.PREEMPTED: PREEMPT_EXIT_CODE,
}


#: JSON object of TrainConfig field overrides a `cli supervise` parent
#: hands its child: the recovery policy's degraded and quarantined knobs,
#: whatever flags spawned the child. `<FIELD>__scale` keys multiply the
#: current value (at least 1). The JAX runner's name for the variable.
SUPERVISE_OVERRIDES_ENV = OVERRIDES_ENV


def _apply_supervise_overrides(train_config: TrainConfig) -> TrainConfig:
    """`train_config` under the supervisor's overrides, rebuilt through the
    constructor so its validation runs (the schedule lengths it derived
    stay: the horizon is not a recovery knob). The `TELEMETRY__*` keys are
    directives, not fields: `TELEMETRY__BEACONS` arms the progress beacons
    before any engine is built, so a respawn after a wedge names the phase
    a repeat wedge hangs in. An unparseable value changes nothing."""
    raw = os.environ.get(SUPERVISE_OVERRIDES_ENV)
    if not raw:
        return train_config
    try:
        overrides = json.loads(raw)
    except ValueError:
        logger.warning("Unparseable %s=%r; ignoring.", SUPERVISE_OVERRIDES_ENV, raw)
        return train_config
    if not isinstance(overrides, dict) or not overrides:
        return train_config
    directives = {k: overrides.pop(k) for k in [k for k in overrides if k.startswith("TELEMETRY__")]}
    if directives.get("TELEMETRY__BEACONS"):
        from ..telemetry.device_stats import arm_beacons

        arm_beacons()
        logger.warning("Supervisor directive TELEMETRY__BEACONS: progress beacons armed for this respawn.")
    if not overrides:
        return train_config
    resolved: dict = {}
    for key, value in overrides.items():
        if key.endswith("__scale"):
            name = key[: -len("__scale")]
            resolved[name] = max(1, round(getattr(train_config, name) * float(value)))
        else:
            resolved[key] = value
    logger.warning("Supervisor recovery overrides active: %s", resolved)
    base = train_config.model_dump()
    base.update(resolved)
    return TrainConfig(**base)


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
    docstring); nothing when the run has no checkpoint yet. Rank 0 reads
    (the process itself when it runs alone) and every rank gets the same
    learner state, counters and spill by one broadcast; the spill is
    read only with a restored checkpoint, or from LOAD_BUFFER_PATH."""
    c = loop.c
    cfg = c.train_config
    payload, read_s = None, 0.0
    if is_primary():
        if cfg.LOAD_CHECKPOINT_PATH:
            loaded = c.checkpoints.restore_path(cfg.LOAD_CHECKPOINT_PATH)
        else:
            loaded = c.checkpoints.restore()
        t0 = time.perf_counter()
        spill = None
        if cfg.LOAD_BUFFER_PATH:
            spill = c.checkpoints.read_spill_path(cfg.LOAD_BUFFER_PATH)
        elif loaded.train_state is not None and not cfg.LOAD_CHECKPOINT_PATH:
            spill = c.checkpoints.read_spill(loaded.global_step)
        read_s = time.perf_counter() - t0
        payload = (loaded.train_state, loaded.counters, loaded.global_step, spill)
    train_state, counters, step, spill = broadcast_object(payload, c.mesh)
    c.checkpoints.install_spill(c.buffer, spill, read_s)
    loop.restored_rows = len(c.buffer)
    if train_state is None:
        return
    c.trainer.set_state(train_state)
    if c.trainer.model is not c.net.model:
        # Self-play and LiveWeights read the net's weights from the new
        # version on; in megastep mode the module is shared.
        c.trainer.sync_to_network()
    loop.set_initial_state(
        step,
        int(counters.get("episodes_played", 0)),
        int(counters.get("total_simulations", 0)),
    )
    loop.weight_updates = int(counters.get("weight_updates", 0))
    logger.info("Resumed at step %d (%d episodes, buffer %d).", step, loop.episodes_played, len(c.buffer))


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
    distributed_config: "DistributedConfig | None" = None,
    mesh_config: "MeshConfig | None" = None,
) -> TrainingLoop:
    """Run (or resume) a training session on `device` (CUDA unless
    named), in the run directory `persistence_config` names (default:
    `TrainConfig.RUN_NAME` under `./.alphatriangle_data`);
    `use_tensorboard` and `telemetry_config` as in
    `setup_training_components`; `log_level` (e.g. "INFO") sets up the
    root logger, which is left alone when None; `distributed_config`
    joins a process group first (see the module docstring) and
    `mesh_config` shapes its mesh."""
    if log_level is not None:
        setup_logging(log_level)
    train_config = _apply_supervise_overrides(train_config or TrainConfig())
    joined = distributed_config is not None and distributed_config.ENABLED
    if joined:
        initialize_distributed(distributed_config, device or "cuda")
        from ..parallel.distributed import process_info

        device = rank_device(device or "cuda", process_info()[0])
        use_tensorboard = use_tensorboard and is_primary()
    try:
        return _run(train_config, env_config, model_config, mcts_config, persistence_config, device,
                    use_tensorboard, telemetry_config, mesh_config, joined)
    finally:
        if joined:
            shutdown_distributed()


def _run(train_config, env_config, model_config, mcts_config, persistence_config, device,
         use_tensorboard, telemetry_config, mesh_config, joined) -> TrainingLoop:
    persistence_config = persistence_config or PersistenceConfig(RUN_NAME=train_config.RUN_NAME)
    train_config, persistence_config = _resolve_auto_resume(train_config, persistence_config)
    if joined:
        # Rank 0's choice of run, so every rank writes beside the same one.
        name = broadcast_object(train_config.RUN_NAME if is_primary() else None)
        train_config = train_config.model_copy(update={"RUN_NAME": name})
        persistence_config = persistence_config.model_copy(update={"RUN_NAME": name})
    components = setup_training_components(
        train_config=train_config,
        env_config=env_config,
        model_config=model_config,
        mcts_config=mcts_config,
        persistence_config=persistence_config,
        device=device,
        use_tensorboard=use_tensorboard,
        telemetry_config=telemetry_config,
        mesh_config=mesh_config,
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
