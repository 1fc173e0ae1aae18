"""ASCII rendering of the triangle board and its shapes: counterpart of
`alphatriangle_tpu/env/render.py`, character for character.

Up-pointing cells ((r + c) even) render as ▲/△, down-pointing as ▼/▽,
death cells as a dot.
"""

import numpy as np

UP_FULL, UP_EMPTY = "▲", "△"
DOWN_FULL, DOWN_EMPTY = "▼", "▽"
DEATH = "·"


def render_grid(occupied: np.ndarray, death: np.ndarray, color: "np.ndarray | None" = None) -> str:
    """A board as lines, with row and column rulers."""
    rows, cols = occupied.shape
    lines = ["    " + " ".join(f"{c % 10}" for c in range(cols))]
    for r in range(rows):
        cells = []
        for c in range(cols):
            if death[r, c]:
                cells.append(DEATH)
            elif (r + c) % 2 == 0:
                cells.append(UP_FULL if occupied[r, c] else UP_EMPTY)
            else:
                cells.append(DOWN_FULL if occupied[r, c] else DOWN_EMPTY)
        lines.append(f"{r:>3} " + " ".join(cells))
    return "\n".join(lines)


def render_shape(triangles: list) -> str:
    """A small picture of one shape's (r, c, is_up) triangles."""
    if not triangles:
        return "(empty)"
    min_r = min(t[0] for t in triangles)
    min_c = min(t[1] for t in triangles)
    max_r = max(t[0] for t in triangles)
    max_c = max(t[1] for t in triangles)
    grid = [[" "] * (max_c - min_c + 1) for _ in range(max_r - min_r + 1)]
    for r, c, is_up in triangles:
        grid[r - min_r][c - min_c] = UP_FULL if is_up else DOWN_FULL
    return "\n".join(" ".join(row).rstrip() for row in grid)
