"""Ops with a hand-written CUDA kernel and a plain PyTorch version."""

from . import gather_rows as _gather_mod
from . import mcts_backup as _backup_mod
from .gather_rows import gather_rows
from .mcts_backup import backup_update

# Every kernel this package launches, by name.
KERNELS = {
    "gather_rows": _gather_mod.KERNEL,
    "backup_update": _backup_mod.KERNEL,
}

__all__ = ["KERNELS", "backup_update", "gather_rows"]
