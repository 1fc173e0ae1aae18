"""Component bundle: counterpart of `alphatriangle_tpu/training/components.py`,
limited to what the single-device loops build: no mesh."""

from dataclasses import dataclass

import torch

from ..config.env_config import EnvConfig
from ..config.mcts_config import MCTSConfig
from ..config.mesh_config import Mesh
from ..config.model_config import ModelConfig
from ..config.persistence_config import PersistenceConfig
from ..config.telemetry_config import TelemetryConfig
from ..config.train_config import TrainConfig
from ..env.engine import TriangleEnv
from ..features.core import FeatureExtractor
from ..nn.network import NeuralNetwork
from ..rl.buffer import ExperienceBuffer
from ..rl.megastep import MegastepRunner
from ..rl.self_play import SelfPlayEngine
from ..rl.trainer import Trainer
from ..stats.collector import StatsCollector
from ..stats.persistence import CheckpointManager
from ..telemetry import RunTelemetry


@dataclass
class TrainingComponents:
    """Everything a training run needs, on one device or one dp rank."""

    env: TriangleEnv
    extractor: FeatureExtractor
    net: NeuralNetwork
    buffer: ExperienceBuffer  # the host ring, or DeviceReplayBuffer (is_device)
    trainer: Trainer
    self_play: SelfPlayEngine
    megastep: "MegastepRunner | None"  # megastep mode only
    checkpoints: CheckpointManager
    stats: StatsCollector

    env_config: EnvConfig
    model_config: ModelConfig
    train_config: TrainConfig
    mcts_config: MCTSConfig
    persistence_config: PersistenceConfig
    device: torch.device

    # The run's telemetry (setup builds it; the loop builds a default one
    # for components assembled by hand) and the config it was built from.
    telemetry: "RunTelemetry | None" = None
    telemetry_config: "TelemetryConfig | None" = None
    # The dp mesh over the process group (None: one device).
    mesh: "Mesh | None" = None
