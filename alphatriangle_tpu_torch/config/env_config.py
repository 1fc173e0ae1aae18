"""Environment (game) configuration: counterpart of
`alphatriangle_tpu/config/env_config.py`, field for field.

Geometry conventions (shared by engine, features and model):
- Cell (r, c) is an up-pointing triangle iff (r + c) is even.
- An up cell shares edges with (r, c-1), (r, c+1), (r+1, c);
  a down cell with (r, c-1), (r, c+1), (r-1, c).
- Action encoding is the flat integer `slot * ROWS * COLS + r * COLS + c`.
"""

from dataclasses import dataclass, field

from ._base import ConfigBase, check_range


def _default_playable_range() -> list[tuple[int, int]]:
    # Symmetric hexagon-ish board on an 8x15 lattice.
    return [
        (3, 12),
        (2, 13),
        (1, 14),
        (0, 15),
        (0, 15),
        (1, 14),
        (2, 13),
        (3, 12),
    ]


@dataclass(frozen=True)
class EnvConfig(ConfigBase):
    """Triangle puzzle environment config (frozen)."""

    ROWS: int = 8
    COLS: int = 15
    # [start_col, end_col) playable window per row; the rest are death cells.
    PLAYABLE_RANGE_PER_ROW: list[tuple[int, int]] = field(
        default_factory=_default_playable_range
    )
    NUM_SHAPE_SLOTS: int = 3
    MAX_SHAPE_TRIANGLES: int = 5
    MIN_SHAPE_TRIANGLES: int = 1
    LINE_MIN_LENGTH: int = 3
    REWARD_PER_PLACED_TRIANGLE: float = 1.0
    REWARD_PER_CLEARED_TRIANGLE: float = 2.0
    PENALTY_GAME_OVER: float = -10.0
    NUM_COLORS: int = 7

    def __post_init__(self) -> None:
        object.__setattr__(
            self,
            "PLAYABLE_RANGE_PER_ROW",
            [(int(lo), int(hi)) for lo, hi in self.PLAYABLE_RANGE_PER_ROW],
        )
        check_range("ROWS", self.ROWS, gt=0)
        check_range("COLS", self.COLS, gt=0)
        check_range("NUM_SHAPE_SLOTS", self.NUM_SHAPE_SLOTS, gt=0)
        check_range("MAX_SHAPE_TRIANGLES", self.MAX_SHAPE_TRIANGLES, ge=1, le=8)
        check_range("MIN_SHAPE_TRIANGLES", self.MIN_SHAPE_TRIANGLES, ge=1)
        check_range("LINE_MIN_LENGTH", self.LINE_MIN_LENGTH, ge=2)
        check_range("NUM_COLORS", self.NUM_COLORS, ge=1)
        if len(self.PLAYABLE_RANGE_PER_ROW) != self.ROWS:
            raise ValueError(
                f"PLAYABLE_RANGE_PER_ROW must have ROWS={self.ROWS} entries, "
                f"got {len(self.PLAYABLE_RANGE_PER_ROW)}."
            )
        for r, (lo, hi) in enumerate(self.PLAYABLE_RANGE_PER_ROW):
            if not (0 <= lo < hi <= self.COLS):
                raise ValueError(
                    f"Row {r}: playable range ({lo}, {hi}) must satisfy "
                    f"0 <= start < end <= COLS={self.COLS}."
                )
        if self.MIN_SHAPE_TRIANGLES > self.MAX_SHAPE_TRIANGLES:
            raise ValueError("MIN_SHAPE_TRIANGLES must be <= MAX_SHAPE_TRIANGLES.")

    @property
    def action_dim(self) -> int:
        """Flat action-space size: NUM_SHAPE_SLOTS * ROWS * COLS."""
        return self.NUM_SHAPE_SLOTS * self.ROWS * self.COLS
