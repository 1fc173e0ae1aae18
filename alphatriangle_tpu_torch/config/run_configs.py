"""Reload a run's own configs from its `configs.json` dump: counterpart
of `alphatriangle_tpu/config/run_configs.py`.

Every run writes its config set to `runs/<run>/configs.json`
(`stats/persistence.py::CheckpointManager.save_configs`) under the JAX
dump's keys (`env`, `model`, `train`, `mcts`, `persistence`), each the
config's `model_dump()`, so either package reads the other's. `cli eval`
and `cli serve --run-name` rebuild the board and net a checkpoint was
trained with from it, instead of assuming the defaults; the model's
NORM_TYPE and INFERENCE_PRECISION come through unchanged, so a run is
served and evaluated at its own precision.
"""

import json
import logging
from pathlib import Path

from .env_config import EnvConfig
from .model_config import ModelConfig
from .validation import expected_other_features_dim

logger = logging.getLogger(__name__)


def load_run_configs(run_dir: Path) -> "dict | None":
    """{'env': EnvConfig, 'model': ModelConfig} from a run directory's
    configs.json, or None when the dump is absent or unreadable."""
    path = Path(run_dir) / "configs.json"
    if not path.is_file():
        return None
    try:
        raw = json.loads(path.read_text())
        return {"env": EnvConfig(**raw["env"]), "model": ModelConfig(**raw["model"])}
    except (ValueError, KeyError, TypeError, OSError) as exc:
        logger.warning("Could not load %s (%s); using defaults.", path, exc)
        return None


def load_run_configs_or_default(run_dir: Path) -> tuple[EnvConfig, ModelConfig]:
    """The run's own (env, model) configs, or the defaults when no
    usable configs.json exists."""
    loaded = load_run_configs(run_dir)
    if loaded:
        return loaded["env"], loaded["model"]
    env = EnvConfig()
    return env, ModelConfig(OTHER_NN_INPUT_FEATURES_DIM=expected_other_features_dim(env))
