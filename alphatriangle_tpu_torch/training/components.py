"""Component bundle: counterpart of `alphatriangle_tpu/training/components.py`,
limited to what the single-device megastep loop builds."""

from dataclasses import dataclass

import torch

from ..config.env_config import EnvConfig
from ..config.mcts_config import MCTSConfig
from ..config.model_config import ModelConfig
from ..config.train_config import TrainConfig
from ..env.engine import TriangleEnv
from ..features.core import FeatureExtractor
from ..nn.network import NeuralNetwork
from ..rl.device_buffer import DeviceReplayBuffer
from ..rl.megastep import MegastepRunner
from ..rl.self_play import SelfPlayEngine
from ..rl.trainer import Trainer


@dataclass
class TrainingComponents:
    """Everything a megastep training run needs, on one device."""

    env: TriangleEnv
    extractor: FeatureExtractor
    net: NeuralNetwork
    buffer: DeviceReplayBuffer
    trainer: Trainer
    self_play: SelfPlayEngine
    megastep: MegastepRunner

    env_config: EnvConfig
    model_config: ModelConfig
    train_config: TrainConfig
    mcts_config: MCTSConfig
    device: torch.device
