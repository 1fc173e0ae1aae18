"""MCTS search configuration: counterpart of
`alphatriangle_tpu/config/mcts_config.py`, field for field.

The kernel knobs keep their names and accept the JAX mode strings, so a
dumped JAX config loads unchanged. On a CUDA tensor every mode runs the
hand-written kernel; on a CPU tensor every mode runs the plain PyTorch
version (ops/). An unknown mode raises ValueError.
"""

import logging
import re
from dataclasses import dataclass

from ._base import ConfigBase, check_range


@dataclass
class AlphaTriangleMCTSConfig(ConfigBase):
    """PUCT search hyperparameters."""

    max_simulations: int = 64
    max_depth: int = 8
    cpuct: float = 1.5
    dirichlet_alpha: float = 0.3
    dirichlet_epsilon: float = 0.25
    discount: float = 1.0
    # Wave size: simulations selected/evaluated in parallel per tree,
    # clamped at run time to the largest divisor of max_simulations.
    mcts_batch_size: int = 32
    # Gumbel perturbation scale on PUCT scores per wave member.
    wave_noise_scale: float = 0.25
    descent_gather: str = "einsum"
    backup_update: str = "xla"
    # Subtree reuse, playout-cap randomization and Gumbel root search
    # are carried for config compatibility; this slice's search is the
    # fresh-root PUCT path and refuses the others (mcts/search.py).
    tree_reuse: bool = False
    tree_reuse_backend: str = "xla"
    tree_reuse_budget: int | None = None
    fast_simulations: int | None = None
    full_search_prob: float = 0.25
    pcr_record_fast_rows: bool = False
    root_selection: str = "puct"
    gumbel_m: int = 16
    gumbel_c_visit: float = 50.0
    gumbel_c_scale: float = 1.0

    def __post_init__(self) -> None:
        check_range("max_simulations", self.max_simulations, gt=0)
        check_range("max_depth", self.max_depth, gt=0)
        check_range("cpuct", self.cpuct, gt=0)
        check_range("dirichlet_alpha", self.dirichlet_alpha, ge=0)
        check_range("dirichlet_epsilon", self.dirichlet_epsilon, ge=0, le=1.0)
        check_range("discount", self.discount, ge=0, le=1.0)
        check_range("mcts_batch_size", self.mcts_batch_size, gt=0)
        check_range("wave_noise_scale", self.wave_noise_scale, ge=0)
        _check_pattern("descent_gather", self.descent_gather, "^(einsum|pallas|take)$")
        _check_pattern("backup_update", self.backup_update, "^(xla|pallas)$")
        _check_pattern("tree_reuse_backend", self.tree_reuse_backend, "^(xla|pallas)$")
        _check_pattern("root_selection", self.root_selection, "^(puct|gumbel)$")
        if self.tree_reuse_budget is not None:
            check_range("tree_reuse_budget", self.tree_reuse_budget, gt=0)
        if self.fast_simulations is not None:
            check_range("fast_simulations", self.fast_simulations, gt=0)
        check_range("full_search_prob", self.full_search_prob, gt=0, le=1.0)
        check_range("gumbel_m", self.gumbel_m, gt=1)
        check_range("gumbel_c_visit", self.gumbel_c_visit, ge=0)
        check_range("gumbel_c_scale", self.gumbel_c_scale, gt=0)
        if (
            self.fast_simulations is not None
            and self.fast_simulations >= self.max_simulations
        ):
            raise ValueError(
                "fast_simulations must be < max_simulations "
                f"({self.fast_simulations} >= {self.max_simulations})"
            )
        if self.tree_reuse and self.fast_simulations is not None:
            raise ValueError(
                "tree_reuse is incompatible with playout cap "
                "randomization (fast_simulations); pick one."
            )
        if self.tree_reuse and self.root_selection == "gumbel":
            raise ValueError(
                "tree_reuse is incompatible with root_selection='gumbel'"
            )
        if self.max_depth > self.max_simulations + 1:
            logging.getLogger(__name__).warning(
                "max_depth=%d exceeds max_simulations+1=%d; the extra depth "
                "can never be reached and only widens path buffers.",
                self.max_depth,
                self.max_simulations + 1,
            )


def _check_pattern(name: str, value: str, pattern: str) -> None:
    if not isinstance(value, str) or re.match(pattern, value) is None:
        raise ValueError(f"{name}={value!r} must match {pattern}")


# Short alias used throughout this package.
MCTSConfig = AlphaTriangleMCTSConfig
