"""Static board geometry: death cells, parity, and clearable lines.

A copy of `alphatriangle_tpu/env/geometry.py` (that package's `env`
imports JAX); tests hold the two equal.

The reference's line/clear rules live in the unvendored C++ engine; the
observable contract is that placements fill cells and completed maximal
lines clear (`alphatriangle/rl/self_play/worker.py:377-378` returns
cleared-triangle counts). This module reconstructs that geometry as
precomputed dense masks so the device engine's clear step is one
`(L, R, C)` reduction — no tracing at run time.

Line families on the triangular lattice (cell (r, c) is up iff (r + c)
is even). Each family is the set of cells between two adjacent parallel
lattice lines of one of the three edge orientations:

- horizontal: successor of (r, c) is (r, c + 1);
- diag1 ("\\", down-right strip): successor is (r, c + 1) from an up
  cell and (r + 1, c) from a down cell;
- diag2 ("/", down-left strip): successor is (r, c - 1) from an up cell
  and (r + 1, c) from a down cell.

A *line* is a maximal run of playable cells along one traversal with at
least `LINE_MIN_LENGTH` cells; a line whose cells are all occupied
clears (all full lines clear simultaneously).
"""

from dataclasses import dataclass

import numpy as np

from ..config.env_config import EnvConfig


def build_death_mask(cfg: EnvConfig) -> np.ndarray:
    """(R, C) bool: True where the cell is permanently unplayable."""
    death = np.ones((cfg.ROWS, cfg.COLS), dtype=bool)
    for r, (lo, hi) in enumerate(cfg.PLAYABLE_RANGE_PER_ROW):
        death[r, lo:hi] = False
    return death


def build_up_mask(rows: int, cols: int) -> np.ndarray:
    """(R, C) bool: True where the cell is an up-pointing triangle."""
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    return (rr + cc) % 2 == 0


def _successor(family: str, r: int, c: int) -> tuple[int, int]:
    up = (r + c) % 2 == 0
    if family == "horizontal":
        return r, c + 1
    if family == "diag1":
        return (r, c + 1) if up else (r + 1, c)
    if family == "diag2":
        return (r, c - 1) if up else (r + 1, c)
    raise ValueError(family)


def _predecessor(family: str, r: int, c: int) -> tuple[int, int]:
    up = (r + c) % 2 == 0
    if family == "horizontal":
        return r, c - 1
    if family == "diag1":
        # inverse of: up -> (r, c+1) [pred of down], down -> (r+1, c) [pred of up]
        return (r - 1, c) if up else (r, c - 1)
    if family == "diag2":
        return (r - 1, c) if up else (r, c + 1)
    raise ValueError(family)


def build_line_masks(cfg: EnvConfig) -> np.ndarray:
    """(L, R, C) bool masks, one per clearable maximal line.

    Lines are bounded by death cells and board edges; only runs with at
    least LINE_MIN_LENGTH cells are kept. A cell can belong to up to
    three lines (one per family).
    """
    death = build_death_mask(cfg)
    playable = ~death
    rows, cols = cfg.ROWS, cfg.COLS

    def in_bounds(r: int, c: int) -> bool:
        return 0 <= r < rows and 0 <= c < cols

    masks: list[np.ndarray] = []
    for family in ("horizontal", "diag1", "diag2"):
        for r0 in range(rows):
            for c0 in range(cols):
                if not playable[r0, c0]:
                    continue
                pr, pc = _predecessor(family, r0, c0)
                if in_bounds(pr, pc) and playable[pr, pc]:
                    continue  # not a run start
                run: list[tuple[int, int]] = []
                r, c = r0, c0
                while in_bounds(r, c) and playable[r, c]:
                    run.append((r, c))
                    r, c = _successor(family, r, c)
                if len(run) >= cfg.LINE_MIN_LENGTH:
                    m = np.zeros((rows, cols), dtype=bool)
                    for rr, cc in run:
                        m[rr, cc] = True
                    masks.append(m)
    if masks:
        return np.stack(masks)
    return np.zeros((0, rows, cols), dtype=bool)


@dataclass(frozen=True)
class EnvGeometry:
    """All static geometry the engine needs, as dense NumPy arrays."""

    death: np.ndarray  # (R, C) bool
    up: np.ndarray  # (R, C) bool
    line_masks: np.ndarray  # (L, R, C) bool

    @property
    def n_lines(self) -> int:
        return int(self.line_masks.shape[0])

    @property
    def n_playable(self) -> int:
        return int((~self.death).sum())


def build_geometry(cfg: EnvConfig) -> EnvGeometry:
    return EnvGeometry(
        death=build_death_mask(cfg),
        up=build_up_mask(cfg.ROWS, cfg.COLS),
        line_masks=build_line_masks(cfg),
    )
