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
As the JAX setup does, it ledgers the run's static memory records
(`telemetry/memory.py`: the learner state's bytes, the replay ring's)
and attaches the run's tracer to the kernel build cache
(`compile_cache.py`), whose builds and loads become `compile/<kernel>`
spans.

In a process group (`parallel/distributed.py`) the mesh is
`MeshConfig.build_mesh` over the ranks, one device each, with its axes'
process groups (`attach_groups`); the overlapped loop runs on a dp-only
mesh, and raises on a mesh with mdl or sp wider than one (ROADMAP.md
item 6e: the mdl line's harvest broadcast would run on a producer
thread, at each rank's own beat). The mesh's axes are reached through
`mesh_config`, as in JAX: no flag of `cli train` sets MDL_SIZE or
SP_SIZE. Self-play lanes ride (dp, sp) (`rollout_lane_axes`): each rank
steps lanes shard `dp_i * SP + sp_i` of the dp x sp shards (`rng.Lanes`;
an indivisible batch raises), replicated over mdl. The learner
all-reduces its gradients over dp, shards its transformer over mdl
(`rl/trainer.py`) and, when sp > 1, attends through
`parallel/ring_attention.make_sp_attention` (SP_ATTENTION: ring or
ulysses); self-play attends densely over its own lanes. The ring is
picked from three tiers (`make_buffer`); a mesh with mdl or sp wider
than one takes the host ring, as JAX's `sharded_ok` asks for a dp-only
mesh, and each ingest's rows are shared over the dp row's replicas
(`training/loop.py` `_shared_rollout`: the mdl line's first rank plays,
the sp line merges its rows in lane order), so the mdl and sp ranks of
a dp row hold and draw bit-equal rows. Rank 0's learner state is broadcast to every
rank. Ranks but the first open no TensorBoard writer and no live file
and run with telemetry off; every rank publishes the same stat-pack
flag, which shapes its work. The utilization meter counts the world's
devices.
"""

import logging
import os

import torch

from ..config.env_config import EnvConfig
from ..config.mcts_config import AlphaTriangleMCTSConfig, MCTSConfig
from ..config.mesh_config import Mesh, MeshConfig, lane_shard_count, rollout_lane_axes
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
from ..parallel.distributed import attach_groups, backend_name, is_primary, process_info
from ..rl.buffer import ExperienceBuffer
from ..rl.device_buffer import DeviceReplayBuffer
from ..rl.megastep import MegastepRunner
from ..rl.sharded_device_buffer import ShardedDeviceReplayBuffer
from ..rl.self_play import SelfPlayEngine
from ..rl.trainer import Trainer
from ..stats.collector import StatsCollector
from ..stats.persistence import CheckpointManager
from ..compile_cache import get_build_cache
from ..telemetry import RunTelemetry
from ..telemetry.device_stats import set_device_stats
from ..telemetry.memory import replay_ring_bytes, replay_ring_record, train_state_record
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
    - dp ranks (a dp-only mesh) with BUFFER_CAPACITY, BATCH_SIZE and
      SELF_PLAY_BATCH_SIZE divisible by dp -> the dp-sharded ring
      (`ShardedDeviceReplayBuffer`, one shard per rank);
    - otherwise -> the host ring, each rank its own (the JAX
      multi-process run's; a mesh with mdl or sp replicas).

    The device ring is wanted for "on", for the megastep (whose ingest
    and sampling run on the card) and for "auto" on a CUDA device; "off"
    and "auto" on the CPU take the host ring, where host and "device"
    memory are the same RAM. The megastep and "on" raise when no device
    tier fits."""
    mesh = mesh or MeshConfig.single_device_mesh()
    mode = train_config.DEVICE_REPLAY
    dp = mesh.dp
    single = mesh.size == 1
    sharded_ok = dp > 1 and mesh.size == dp and all(
        v % dp == 0
        for v in (train_config.BUFFER_CAPACITY, train_config.BATCH_SIZE,
                  train_config.SELF_PLAY_BATCH_SIZE)
    )
    if (train_config.FUSED_MEGASTEP or mode == "on") and not (single or sharded_ok):
        raise ValueError(
            f"{'FUSED_MEGASTEP' if train_config.FUSED_MEGASTEP else 'DEVICE_REPLAY=on'} needs one "
            "rank, or a dp-only mesh (no mdl or sp replication) with BUFFER_CAPACITY, BATCH_SIZE "
            f"and SELF_PLAY_BATCH_SIZE divisible by dp (got {mesh.shape}); use "
            "DEVICE_REPLAY='auto' for the host ring."
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
    """The run's mesh over the process group (one device per rank) with
    its axes' process groups; the single-device mesh without a group,
    where a DP_SIZE the one process cannot meet falls back to one device
    with a warning, as the JAX setup does (an mdl or sp axis the world
    cannot hold raises)."""
    mesh_config = mesh_config or MeshConfig()
    if train_config.ASYNC_ROLLOUTS and (mesh_config.MDL_SIZE > 1 or mesh_config.SP_SIZE > 1):
        raise ValueError(
            f"ASYNC_ROLLOUTS on a mesh with MDL_SIZE={mesh_config.MDL_SIZE}, "
            f"SP_SIZE={mesh_config.SP_SIZE}: the overlapped loop runs on a dp-only mesh; over "
            "mdl or sp it waits for ROADMAP.md item 6e"
        )
    rank, world = process_info()
    backend = backend_name()
    try:
        mesh = mesh_config.build_mesh(world, rank, backend)
    except ValueError as exc:
        if backend is not None or mesh_config.MDL_SIZE > 1 or mesh_config.SP_SIZE > 1:
            raise
        logger.warning("Mesh build failed (%s); single-device fallback.", exc)
        mesh = MeshConfig.single_device_mesh()
    shards = lane_shard_count(mesh, rollout_lane_axes(mesh, *mesh.axis_names[::2]))
    if train_config.SELF_PLAY_BATCH_SIZE % shards != 0:
        raise ValueError(
            f"SELF_PLAY_BATCH_SIZE={train_config.SELF_PLAY_BATCH_SIZE} must divide evenly over "
            f"the {shards} lane shards (each rank steps its share of the lanes)."
        )
    return attach_groups(mesh)


def rank_lanes(mesh: Mesh, total: int) -> "Lanes | None":
    """This rank's lanes: shard `dp_i * SP + sp_i` of the dp x sp lane
    shards (the lanes of the mdl line, which its first rank plays); None on a
    mesh of one lane shard."""
    shards = mesh.dp * mesh.sp
    if shards == 1:
        return None
    per = total // shards
    shard = mesh.dp_index * mesh.sp + mesh.sp_index
    return Lanes(shard * per, (shard + 1) * per, total)


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
    # Self-play's net attends densely over its own lanes; the learner's
    # copy takes the sequence-parallel core when the mesh has an sp axis.
    buffer = make_buffer(train_config, env_config, model_config, extractor, device, mesh)
    net = NeuralNetwork(model_config, env_config, seed=train_config.RANDOM_SEED, device=device)
    attention_fn = None
    if mesh.sp > 1:
        from ..parallel.ring_attention import make_sp_attention

        mesh_config = mesh_config or MeshConfig()
        attention_fn = make_sp_attention(mesh, kind=mesh_config.SP_ATTENTION)
        logger.info("Sequence-parallel attention: %s over sp=%d", mesh_config.SP_ATTENTION, mesh.sp)
    trainer = Trainer(net, train_config, mesh=mesh, attention_fn=attention_fn)
    if mesh.mdl > 1:
        logger.info("Tensor parallelism: transformer shards over mdl=%d (Megatron layout).", mesh.mdl)
    trainer.broadcast_state()
    lanes = rank_lanes(mesh, train_config.SELF_PLAY_BATCH_SIZE)
    if lanes is not None:
        logger.info("Self-play lanes [%d, %d) of %d on rank %d.", lanes.lo, lanes.hi, lanes.total, mesh.rank)
    self_play = SelfPlayEngine(
        env, extractor, net, mcts_config, train_config, seed=train_config.RANDOM_SEED + 1, lanes=lanes,
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
        mesh_devices=mesh.size,
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
    # Kernel builds and loads become compile/<kernel> spans in trace.json.
    get_build_cache().set_tracer(telemetry.tracer)
    self_play.flight = trainer.flight = telemetry.flight
    if megastep is not None:
        megastep.flight = telemetry.flight
    # Static memory attribution (telemetry/memory.py): the learner state's
    # bytes, and the ring's (the device rings' own storage; the host ring's
    # from its geometry, as the JAX setup counts it).
    telemetry.record_memory(train_state_record(trainer))
    if buffer.is_device:
        telemetry.record_memory(buffer.memory_record())
    else:
        telemetry.record_memory(replay_ring_record(
            replay_ring_bytes(
                train_config.BUFFER_CAPACITY,
                (model_config.GRID_INPUT_CHANNELS, env_config.ROWS, env_config.COLS),
                extractor.other_dim, env_config.action_dim,
            ),
            train_config.BUFFER_CAPACITY, location="host",
        ))
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
