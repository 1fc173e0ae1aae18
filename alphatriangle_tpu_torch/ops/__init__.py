"""Ops with a hand-written CUDA kernel and a plain PyTorch version."""

from . import gather_rows as _gather_mod
from . import mcts_backup as _backup_mod
from . import per_sample as _per_sample_mod
from . import subtree_reuse as _subtree_mod
from .gather_rows import gather_rows
from .mcts_backup import backup_update
from .per_sample import count_below, per_sample
from .subtree_reuse import subtree_promote

# Every kernel this package launches, by name.
KERNELS = {
    "gather_rows": _gather_mod.KERNEL,
    "backup_update": _backup_mod.KERNEL,
    "per_sample": _per_sample_mod.KERNEL,
    "subtree_promote": _subtree_mod.KERNEL,
}

__all__ = [
    "KERNELS", "backup_update", "count_below", "gather_rows", "per_sample", "subtree_promote",
]
