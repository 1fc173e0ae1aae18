"""Component construction: counterpart of
`alphatriangle_tpu/training/setup.py` (`setup_training_components`,
`clamp_self_play_workers`, `_make_buffer`), on one device or as one
rank of a dp run.

The port builds the env, the feature extractor, the net (on the given
device, CUDA unless the caller names another), the learner, the replay
ring, the rollout engine, in megastep mode the megastep runner, the
run's `CheckpointManager`, which makes the run directory and writes its
`configs.json`, the `StatsCollector` (`live_metrics.jsonl`, and
TensorBoard with `use_tensorboard` where it imports), which records the
configs, and the run's `RunTelemetry`: a `UtilizationMeter` on the run's
own FLOPs and the device's name (`torch.cuda.get_device_name`, "cpu" on
the CPU), the collector's tick sink into the metrics ledger, and the
flight recorder attached to self-play, the learner and the megastep.
Before any engine exists it publishes the device stat-pack flag
(`set_device_stats(TelemetryConfig.ENABLED)`), which the searches read
when they are built. The device is resolved before anything touches
the disk, so a CUDA request without a card makes no directory. The
learner shares the net's module only in megastep mode (rl/trainer.py).
The compile-cache tracer and the memory records of the JAX setup wait
for a later slice.

In a process group (`parallel/distributed.py`) the mesh is
`MeshConfig.build_mesh` over the ranks, one device each (MDL_SIZE or
SP_SIZE above 1 raise, as does the overlapped loop: ROADMAP.md item
6b). Each rank steps its SELF_PLAY_BATCH_SIZE / dp lanes
(`rng.Lanes`; an indivisible batch raises), the learner all-reduces its
gradients, and the ring is picked from three tiers (`make_buffer`).
Rank 0's learner state is broadcast to every rank. Ranks but the first
open no TensorBoard writer and no live file and run with telemetry
off; every rank publishes the same stat-pack flag, which shapes its
work. The utilization meter counts the world's devices.
"""

import logging
import os

import torch

from ..config.env_config import EnvConfig
from ..config.mcts_config import AlphaTriangleMCTSConfig, MCTSConfig
from ..config.mesh_config import Mesh, MeshConfig
from ..config.model_config import ModelConfig
from ..config.persistence_config import PersistenceConfig
from ..config.telemetry_config import TelemetryConfig
from ..config.train_config import TrainConfig
from ..config.validation import expected_other_features_dim
from ..device import resolve_device
from ..env.engine import TriangleEnv
from ..features.core import FeatureExtractor
from ..rng import Lanes
from ..nn.network import NeuralNetwork
from ..parallel.distributed import backend_name, is_primary, process_info
from ..rl.buffer import ExperienceBuffer
from ..rl.device_buffer import DeviceReplayBuffer
from ..rl.megastep import MegastepRunner
from ..rl.sharded_device_buffer import ShardedDeviceReplayBuffer
from ..rl.self_play import SelfPlayEngine
from ..rl.trainer import Trainer
from ..stats.collector import StatsCollector
from ..stats.persistence import CheckpointManager
from ..telemetry import RunTelemetry
from ..telemetry.device_stats import set_device_stats
from ..telemetry.perf import UtilizationMeter
from ..utils.flops import forward_flops, train_step_flops
from .components import TrainingComponents

logger = logging.getLogger(__name__)

# Rollout streams per card: each is a producer thread with its own
# 512-lane engine and CUDA stream; past a few per card the streams and
# the learner only queue behind one another.
MAX_STREAMS_PER_DEVICE = 4


def clamp_self_play_workers(requested: int, device) -> int:
    """Clamp the rollout-stream count to the host and device budget:
    MAX_STREAMS_PER_DEVICE per card (producer threads there spend their
    time waiting on the card, so cores do not bind); cores - 2 when the
    "device" is the host CPU (the reference's rule for its CPU-bound
    actors). Warns when it clamps."""
    cores = os.cpu_count() or 1
    if torch.device(device).type == "cpu":
        cap = max(1, min(cores - 2 if cores > 2 else 1, MAX_STREAMS_PER_DEVICE))
    else:
        cap = MAX_STREAMS_PER_DEVICE
    if requested > cap:
        logger.warning(
            "NUM_SELF_PLAY_WORKERS=%d exceeds this host's budget (%d cores, device %s); "
            "clamping to %d streams.",
            requested, cores, device, cap,
        )
        return cap
    return requested


def make_buffer(
    train_config: TrainConfig,
    env_config: EnvConfig,
    model_config: ModelConfig,
    extractor,
    device,
    mesh: "Mesh | None" = None,
) -> ExperienceBuffer:
    """The replay ring's home per `DEVICE_REPLAY`, in three tiers:

    - one rank -> the device ring (`DeviceReplayBuffer`);
    - dp ranks with BUFFER_CAPACITY, BATCH_SIZE and SELF_PLAY_BATCH_SIZE
      divisible by dp -> the dp-sharded ring (`ShardedDeviceReplayBuffer`,
      one shard per rank);
    - otherwise -> the host ring, each rank its own (the JAX
      multi-process run's).

    The device ring is wanted for "on", for the megastep (whose ingest
    and sampling run on the card) and for "auto" on a CUDA device; "off"
    and "auto" on the CPU take the host ring, where host and "device"
    memory are the same RAM. The megastep and "on" raise when no device
    tier fits."""
    mesh = mesh or MeshConfig.single_device_mesh()
    mode = train_config.DEVICE_REPLAY
    dp = mesh.dp
    single = dp == 1
    sharded_ok = dp > 1 and all(
        v % dp == 0
        for v in (train_config.BUFFER_CAPACITY, train_config.BATCH_SIZE,
                  train_config.SELF_PLAY_BATCH_SIZE)
    )
    if (train_config.FUSED_MEGASTEP or mode == "on") and not (single or sharded_ok):
        raise ValueError(
            f"{'FUSED_MEGASTEP' if train_config.FUSED_MEGASTEP else 'DEVICE_REPLAY=on'} needs one "
            "rank, or dp ranks with BUFFER_CAPACITY, BATCH_SIZE and SELF_PLAY_BATCH_SIZE "
            f"divisible by dp (got dp={dp}); use DEVICE_REPLAY='auto' for the host ring."
        )
    want = (
        mode == "on"
        or (mode == "auto" and device.type != "cpu")
        or train_config.FUSED_MEGASTEP
    )
    grid_shape = (model_config.GRID_INPUT_CHANNELS, env_config.ROWS, env_config.COLS)
    if want and single:
        logger.info("Device-resident replay ring: capacity %d on %s.", train_config.BUFFER_CAPACITY, device)
        return DeviceReplayBuffer(
            train_config, grid_shape=grid_shape, other_dim=extractor.other_dim,
            action_dim=env_config.action_dim, device=device,
        )
    if want and sharded_ok:
        logger.info(
            "dp-sharded device replay ring: capacity %d over %d shards (shard %d on %s).",
            train_config.BUFFER_CAPACITY, dp, mesh.dp_index, device,
        )
        return ShardedDeviceReplayBuffer(
            train_config, grid_shape=grid_shape, other_dim=extractor.other_dim,
            action_dim=env_config.action_dim, device=device, mesh=mesh,
        )
    if want:
        logger.info("DEVICE_REPLAY=%s: dp=%d not eligible for a device ring -> host buffer.", mode, dp)
    return ExperienceBuffer(train_config, action_dim=env_config.action_dim)


def build_mesh(mesh_config: "MeshConfig | None", train_config: TrainConfig) -> Mesh:
    """The run's mesh over the process group (one device per rank); the
    single-device mesh without a group, where a DP_SIZE the one process
    cannot meet falls back to one device with a warning, as the JAX
    setup does."""
    mesh_config = mesh_config or MeshConfig()
    rank, world = process_info()
    backend = backend_name()
    try:
        mesh = mesh_config.build_mesh(world, rank, backend)
    except ValueError as exc:
        if backend is not None or mesh_config.MDL_SIZE > 1 or mesh_config.SP_SIZE > 1:
            raise
        logger.warning("Mesh build failed (%s); single-device fallback.", exc)
        mesh = MeshConfig.single_device_mesh()
    if backend is not None and train_config.ASYNC_ROLLOUTS:
        raise ValueError(
            "ASYNC_ROLLOUTS under torch.distributed: the overlapped loop across ranks "
            "waits for ROADMAP.md item 6b"
        )
    # The lanes shard over dp alone: build_mesh refuses SP_SIZE > 1.
    if train_config.SELF_PLAY_BATCH_SIZE % mesh.dp != 0:
        raise ValueError(
            f"SELF_PLAY_BATCH_SIZE={train_config.SELF_PLAY_BATCH_SIZE} must divide evenly over "
            f"the {mesh.dp} lane shards (each rank steps its share of the lanes)."
        )
    return mesh


def setup_training_components(
    train_config: "TrainConfig | None" = None,
    env_config: "EnvConfig | None" = None,
    model_config: "ModelConfig | None" = None,
    mcts_config: "MCTSConfig | None" = None,
    persistence_config: "PersistenceConfig | None" = None,
    device=None,
    use_tensorboard: bool = False,
    telemetry_config: "TelemetryConfig | None" = None,
    mesh_config: "MeshConfig | None" = None,
) -> TrainingComponents:
    """Validate configs and build every training component on `device`;
    the run directory is `persistence_config`'s (default: run
    `RUN_NAME` under `./.alphatriangle_data`). `use_tensorboard` adds
    the TensorBoard writer to the stats collector (`cli train` asks
    for it unless --no-tensorboard); `telemetry_config` configures the
    run's telemetry (default: all of it on)."""
    train_config = train_config or TrainConfig()
    env_config = env_config or EnvConfig()
    model_config = model_config or ModelConfig(
        OTHER_NN_INPUT_FEATURES_DIM=expected_other_features_dim(env_config)
    )
    mcts_config = mcts_config or AlphaTriangleMCTSConfig()
    device = resolve_device(device)
    mesh = build_mesh(mesh_config, train_config)
    primary = is_primary()
    # The searches snapshot the stat-pack flag when they are built; every
    # rank publishes the same one.
    telemetry_config = telemetry_config or TelemetryConfig()
    set_device_stats(telemetry_config.ENABLED)
    if not primary:
        telemetry_config = telemetry_config.model_copy(update={"ENABLED": False})

    env = TriangleEnv(env_config, device=device)
    extractor = FeatureExtractor(env, model_config)
    net = NeuralNetwork(model_config, env_config, seed=train_config.RANDOM_SEED, device=device)
    trainer = Trainer(net, train_config, mesh=mesh)
    trainer.broadcast_state()
    buffer = make_buffer(train_config, env_config, model_config, extractor, device, mesh)
    lanes = None
    if mesh.dp > 1:
        per = train_config.SELF_PLAY_BATCH_SIZE // mesh.dp
        lanes = Lanes(mesh.dp_index * per, (mesh.dp_index + 1) * per, train_config.SELF_PLAY_BATCH_SIZE)
        logger.info("Self-play lanes [%d, %d) of %d on rank %d.", lanes.lo, lanes.hi, lanes.total, mesh.dp_index)
    self_play = SelfPlayEngine(
        env, extractor, net, mcts_config, train_config, seed=train_config.RANDOM_SEED + 1, lanes=lanes
    )
    megastep = None
    if train_config.FUSED_MEGASTEP:
        megastep = MegastepRunner(self_play, trainer, buffer, train_config)
        logger.info(
            "Fused megastep mode on %s: %d lanes, %d moves + %d learner steps per megastep.",
            device,
            self_play.batch_size,
            train_config.ROLLOUT_CHUNK_MOVES,
            megastep.steps_per_megastep,
        )
    else:
        logger.info(
            "%s loop on %s: %d lanes, %d-move chunks, %s replay ring.",
            "Overlapped" if train_config.ASYNC_ROLLOUTS else "Synchronous",
            device,
            self_play.batch_size,
            train_config.ROLLOUT_CHUNK_MOVES,
            "device" if buffer.is_device else "host",
        )
    persistence_config = persistence_config or PersistenceConfig(RUN_NAME=train_config.RUN_NAME)
    checkpoints = CheckpointManager(persistence_config, device=device)
    all_configs = {
        "env": env_config,
        "model": model_config,
        "train": train_config,
        "mcts": mcts_config,
        "persistence": persistence_config,
    }
    checkpoints.save_configs(all_configs)
    stats = StatsCollector(
        persistence_config, use_tensorboard=use_tensorboard and primary, use_live_file=primary
    )
    stats.log_params(all_configs)
    perf_meter = UtilizationMeter(
        forward_flops=forward_flops(model_config, env_config, env_config.action_dim),
        train_step_flops=train_step_flops(
            model_config, env_config, env_config.action_dim, train_config.BATCH_SIZE
        ),
        device_kind=torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        buffer_capacity=train_config.BUFFER_CAPACITY,
        mesh_devices=mesh.dp,
    )
    telemetry = RunTelemetry(
        telemetry_config,
        run_dir=persistence_config.get_run_base_dir(),
        stats=stats,
        run_name=persistence_config.RUN_NAME,
        perf=perf_meter,
    )
    # Every processed metric batch lands in the ledger, the final flushes
    # included; every dispatch family writes its intent and seal records.
    stats.set_tick_sink(telemetry.record_metrics)
    self_play.flight = trainer.flight = telemetry.flight
    if megastep is not None:
        megastep.flight = telemetry.flight
    return TrainingComponents(
        env=env,
        extractor=extractor,
        net=net,
        buffer=buffer,
        trainer=trainer,
        self_play=self_play,
        megastep=megastep,
        checkpoints=checkpoints,
        stats=stats,
        env_config=env_config,
        model_config=model_config,
        train_config=train_config,
        mcts_config=mcts_config,
        persistence_config=persistence_config,
        device=device,
        telemetry=telemetry,
        telemetry_config=telemetry_config,
        mesh=mesh,
    )
