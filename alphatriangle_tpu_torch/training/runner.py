"""Top-level `run_training`: counterpart of
`alphatriangle_tpu/training/runner.py::run_training`, in every loop
mode the config selects (synchronous unless `ASYNC_ROLLOUTS` or
`FUSED_MEGASTEP`).

Builds the components (`setup.py`) and runs the loop; returns the
finished `TrainingLoop` (its `status`, `metrics` and `report()`), which
`EXIT_CODES` maps to a process exit code. A config the port cannot run
raises ValueError from setup, before anything is built. Auto-resume,
restores and the final save wait for the checkpoint slice.
"""

import logging

from ..config.env_config import EnvConfig
from ..config.mcts_config import MCTSConfig
from ..config.model_config import ModelConfig
from ..config.train_config import TrainConfig
from .loop import LoopStatus, TrainingLoop
from .setup import setup_training_components

logger = logging.getLogger(__name__)

EXIT_CODES = {LoopStatus.COMPLETED: 0, LoopStatus.STOPPED: 0, LoopStatus.ERROR: 1}


def run_training(
    train_config: "TrainConfig | None" = None,
    env_config: "EnvConfig | None" = None,
    model_config: "ModelConfig | None" = None,
    mcts_config: "MCTSConfig | None" = None,
    device=None,
) -> TrainingLoop:
    """Run a training session on `device` (CUDA unless named)."""
    components = setup_training_components(
        train_config=train_config,
        env_config=env_config,
        model_config=model_config,
        mcts_config=mcts_config,
        device=device,
    )
    loop = TrainingLoop(components)
    status = loop.run()
    logger.info("Training finished: %s", status.value)
    return loop
