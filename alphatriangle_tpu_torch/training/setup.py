"""Component construction: counterpart of
`alphatriangle_tpu/training/setup.py::setup_training_components`, for
the one loop mode the port runs, the fused megastep on one device.

The port builds the env, the feature extractor, the net (on the given
device, CUDA unless the caller names another), the learner, the device
ring, the rollout engine and the megastep runner. Checkpoints, stats,
telemetry and meshes wait for later slices; `refuse_unported` raises for
a config that asks for a mode the port does not have.
"""

import logging

from ..config.env_config import EnvConfig
from ..config.mcts_config import AlphaTriangleMCTSConfig, MCTSConfig
from ..config.model_config import ModelConfig
from ..config.train_config import TrainConfig
from ..config.validation import expected_other_features_dim
from ..device import resolve_device
from ..env.engine import TriangleEnv
from ..features.core import FeatureExtractor
from ..nn.network import NeuralNetwork
from ..rl.device_buffer import DeviceReplayBuffer
from ..rl.megastep import MegastepRunner
from ..rl.self_play import SelfPlayEngine
from ..rl.trainer import Trainer
from .components import TrainingComponents

logger = logging.getLogger(__name__)

ONLY_MEGASTEP = (
    "only the fused megastep loop is ported yet: set FUSED_MEGASTEP=True "
    "(cli train --fused-megastep)"
)


def refuse_unported(cfg: TrainConfig) -> None:
    """Raise ValueError for a loop mode or feature the port lacks."""
    if cfg.ASYNC_ROLLOUTS:
        raise ValueError("ASYNC_ROLLOUTS (the overlapped loop) is not ported yet; " + ONLY_MEGASTEP)
    if not cfg.FUSED_MEGASTEP:
        raise ValueError(ONLY_MEGASTEP)
    if cfg.LOAD_CHECKPOINT_PATH or cfg.LOAD_BUFFER_PATH:
        raise ValueError("checkpoint and buffer restore are not ported yet")


def setup_training_components(
    train_config: "TrainConfig | None" = None,
    env_config: "EnvConfig | None" = None,
    model_config: "ModelConfig | None" = None,
    mcts_config: "MCTSConfig | None" = None,
    device=None,
) -> TrainingComponents:
    """Validate configs and build every training component on `device`."""
    train_config = train_config or TrainConfig()
    env_config = env_config or EnvConfig()
    model_config = model_config or ModelConfig(
        OTHER_NN_INPUT_FEATURES_DIM=expected_other_features_dim(env_config)
    )
    mcts_config = mcts_config or AlphaTriangleMCTSConfig()
    refuse_unported(train_config)
    device = resolve_device(device)

    env = TriangleEnv(env_config, device=device)
    extractor = FeatureExtractor(env, model_config)
    net = NeuralNetwork(model_config, env_config, seed=train_config.RANDOM_SEED, device=device)
    trainer = Trainer(net, train_config)
    buffer = DeviceReplayBuffer(
        train_config,
        grid_shape=(model_config.GRID_INPUT_CHANNELS, env_config.ROWS, env_config.COLS),
        other_dim=extractor.other_dim,
        action_dim=env_config.action_dim,
        device=device,
    )
    self_play = SelfPlayEngine(
        env, extractor, net, mcts_config, train_config, seed=train_config.RANDOM_SEED + 1
    )
    megastep = MegastepRunner(self_play, trainer, buffer, train_config)
    logger.info(
        "Fused megastep mode on %s: %d lanes, %d moves + %d learner steps per megastep.",
        device,
        self_play.batch_size,
        train_config.ROLLOUT_CHUNK_MOVES,
        megastep.steps_per_megastep,
    )
    return TrainingComponents(
        env=env,
        extractor=extractor,
        net=net,
        buffer=buffer,
        trainer=trainer,
        self_play=self_play,
        megastep=megastep,
        env_config=env_config,
        model_config=model_config,
        train_config=train_config,
        mcts_config=mcts_config,
        device=device,
    )
