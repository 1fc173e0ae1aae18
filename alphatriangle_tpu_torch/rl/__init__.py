"""Self-play, replay, the learner and the fused megastep."""

from .buffer import ExperienceBuffer
from .device_buffer import DeviceReplayBuffer, ring_scatter
from .megastep import MegastepRunner
from .self_play import RolloutCarry, SelfPlayEngine
from .trainer import Trainer, TrainState, make_lr_schedule, project_to_support
from .types import SelfPlayResult

__all__ = [
    "DeviceReplayBuffer",
    "ExperienceBuffer",
    "MegastepRunner",
    "RolloutCarry",
    "SelfPlayEngine",
    "SelfPlayResult",
    "TrainState",
    "Trainer",
    "make_lr_schedule",
    "project_to_support",
    "ring_scatter",
]
