"""Training in fused-megastep mode: components, setup, loop and runner."""

from .components import TrainingComponents
from .loop import LoopStatus, TrainingLoop
from .runner import EXIT_CODES, run_training
from .setup import refuse_unported, setup_training_components

__all__ = [
    "EXIT_CODES",
    "LoopStatus",
    "TrainingComponents",
    "TrainingLoop",
    "refuse_unported",
    "run_training",
    "setup_training_components",
]
