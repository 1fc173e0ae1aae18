"""Training: components, setup, the loop in its three modes, and the runner."""

from .components import TrainingComponents
from .loop import LoopStatus, TrainingLoop
from .runner import EXIT_CODES, run_training
from .setup import clamp_self_play_workers, setup_training_components

__all__ = [
    "EXIT_CODES",
    "LoopStatus",
    "TrainingComponents",
    "TrainingLoop",
    "clamp_self_play_workers",
    "run_training",
    "setup_training_components",
]
