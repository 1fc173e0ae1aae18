"""Run-directory layout and save cadences: counterpart of
`alphatriangle_tpu/config/persistence_config.py`, field for field, with
the same defaults and `get_*_dir` layout
(`<ROOT_DATA_DIR>/<APP_NAME>/runs/<RUN_NAME>/{checkpoints,buffers,logs,
tensorboard,profile_data}`), so a JAX `model_dump()` loads unchanged.

One default differs: `APP_NAME` is the port's own,
`"AlphaTriangleTPUTorch"`, where the JAX package's is
`"AlphaTriangleTPU"`. A JAX run's step directories hold Orbax trees,
which the port cannot read (it imports no JAX), so the port's
auto-resume must never pick one up: with its own app directory the two
packages' runs sit side by side under one root and neither resumes the
other's. A JAX learner crosses over through `nn/convert.py`'s
`train_state_from_flax`, and a replay ring through the buffer spill,
whose format both sides share.
"""

from dataclasses import dataclass
from pathlib import Path

from ._base import ConfigBase, check_range
from .app_config import APP_NAME


@dataclass
class PersistenceConfig(ConfigBase):
    """Filesystem layout + save cadences for a training run."""

    APP_NAME: str = APP_NAME
    RUN_NAME: str = "default_run"
    ROOT_DATA_DIR: str = ".alphatriangle_data"
    SAVE_BUFFER: bool = True
    BUFFER_SAVE_FREQ_STEPS: int = 10_000
    MLFLOW_TRACKING_URI: str | None = None
    # Retention: keep only the newest K checkpoints / buffer spills
    # (0 = unlimited).
    KEEP_LAST_CHECKPOINTS: int = 5
    KEEP_LAST_BUFFERS: int = 2

    def __post_init__(self) -> None:
        check_range("BUFFER_SAVE_FREQ_STEPS", self.BUFFER_SAVE_FREQ_STEPS, ge=1)
        check_range("KEEP_LAST_CHECKPOINTS", self.KEEP_LAST_CHECKPOINTS, ge=0)
        check_range("KEEP_LAST_BUFFERS", self.KEEP_LAST_BUFFERS, ge=0)

    def get_app_root_dir(self) -> Path:
        return Path(self.ROOT_DATA_DIR) / self.APP_NAME

    def get_runs_root_dir(self) -> Path:
        return self.get_app_root_dir() / "runs"

    def get_run_base_dir(self) -> Path:
        return self.get_runs_root_dir() / self.RUN_NAME

    def get_checkpoint_dir(self) -> Path:
        return self.get_run_base_dir() / "checkpoints"

    def get_buffer_dir(self) -> Path:
        return self.get_run_base_dir() / "buffers"

    def get_log_dir(self) -> Path:
        return self.get_run_base_dir() / "logs"

    def get_tensorboard_dir(self) -> Path:
        return self.get_run_base_dir() / "tensorboard"

    def get_profile_dir(self) -> Path:
        return self.get_run_base_dir() / "profile_data"

    def create_run_dirs(self) -> None:
        for d in (
            self.get_checkpoint_dir(),
            self.get_buffer_dir(),
            self.get_log_dir(),
            self.get_tensorboard_dir(),
            self.get_profile_dir(),
        ):
            d.mkdir(parents=True, exist_ok=True)
