"""Shape bank: the static library of placeable triangle shapes.

A copy of `alphatriangle_tpu/env/shapes.py` (that package's `env`
imports JAX); tests hold the two banks equal.

The reference's engine ships shapes inside the unvendored C++
`trianglengin` package (`Shape.triangles: list[(r, c, is_up)]`,
`Shape.bbox()` — observed at `alphatriangle/features/extractor.py:58-66`).
Here the bank is enumerated deterministically from the config: all
connected triangle polyiamonds with `MIN_SHAPE_TRIANGLES` to
`MAX_SHAPE_TRIANGLES` cells, in fixed orientation, deduplicated under
parity-preserving translation. Both anchor parities are kept as distinct
shapes, which is what makes every physical placement reachable from an
even-parity origin (see `EnvConfig` geometry notes).

The bank is materialized as fixed-shape NumPy arrays (padded to
`MAX_SHAPE_TRIANGLES` triangles) so the device engine can gather shape
geometry with static shapes.
"""

from dataclasses import dataclass, field

import numpy as np

from ..config.env_config import EnvConfig

Cell = tuple[int, int]


def _is_up(r: int, c: int) -> bool:
    """Cell (r, c) is an up-pointing triangle iff (r + c) is even."""
    return (r + c) % 2 == 0


def _neighbors(r: int, c: int) -> list[Cell]:
    """Edge-adjacent cells on the triangular lattice."""
    if _is_up(r, c):
        return [(r, c - 1), (r, c + 1), (r + 1, c)]
    return [(r, c - 1), (r, c + 1), (r - 1, c)]


def _canonicalize(cells: frozenset[Cell]) -> tuple[Cell, ...]:
    """Translate so min row is 0 and min col is 0 or 1, preserving parity.

    A translation by (dr, dc) keeps up/down-ness iff (dr + dc) is even,
    so dc is rounded to keep the shift parity even.
    """
    min_r = min(r for r, _ in cells)
    min_c = min(c for _, c in cells)
    dc = min_c if (min_r + min_c) % 2 == 0 else min_c - 1
    return tuple(sorted((r - min_r, c - dc) for r, c in cells))


def enumerate_shapes(min_tris: int, max_tris: int) -> list[tuple[Cell, ...]]:
    """All fixed-orientation connected shapes with min..max triangles.

    Deterministic: breadth-first growth from the two single-triangle
    seeds, canonicalized each level. Counts follow the fixed polyiamond
    series (2, 3, 6, 14, 36 for sizes 1-5).
    """
    level: set[tuple[Cell, ...]] = {
        _canonicalize(frozenset({(0, 0)})),  # up seed
        _canonicalize(frozenset({(0, 1)})),  # down seed
    }
    out: list[tuple[Cell, ...]] = []
    for size in range(1, max_tris + 1):
        if size >= min_tris:
            out.extend(sorted(level))
        if size == max_tris:
            break
        nxt: set[tuple[Cell, ...]] = set()
        for shape in level:
            cells = set(shape)
            for r, c in shape:
                for nb in _neighbors(r, c):
                    if nb not in cells:
                        nxt.add(_canonicalize(frozenset(cells | {nb})))
        level = nxt
    return out


@dataclass(frozen=True)
class ShapeBank:
    """Dense, padded arrays describing every shape in the bank.

    All arrays have leading dim `n_shapes`; triangle dims are padded to
    `max_tris` with `tri_valid` marking real entries.
    """

    tri_r: np.ndarray  # (S, T) int32 row offsets
    tri_c: np.ndarray  # (S, T) int32 col offsets
    tri_up: np.ndarray  # (S, T) bool: triangle is up-pointing
    tri_valid: np.ndarray  # (S, T) bool: padding mask
    n_tris: np.ndarray  # (S,) int32
    shapes: list[tuple[Cell, ...]] = field(repr=False)  # host-side geometry

    @property
    def n_shapes(self) -> int:
        return int(self.tri_r.shape[0])

    @property
    def max_tris(self) -> int:
        return int(self.tri_r.shape[1])


def bank_shape_triangles(
    bank: ShapeBank, shape_idx: int
) -> list[tuple[int, int, bool]]:
    """One shape's (r, c, is_up) triangle list (reference
    `trianglengin.Shape.triangles` surface)."""
    return [
        (int(r), int(c), _is_up(int(r), int(c)))
        for r, c in bank.shapes[shape_idx]
    ]


def build_shape_bank(cfg: EnvConfig) -> ShapeBank:
    """Enumerate and densify the shape bank for a config."""
    shapes = enumerate_shapes(cfg.MIN_SHAPE_TRIANGLES, cfg.MAX_SHAPE_TRIANGLES)
    if not shapes:
        raise ValueError("shape bank is empty; check MIN/MAX_SHAPE_TRIANGLES")
    s, t = len(shapes), cfg.MAX_SHAPE_TRIANGLES
    tri_r = np.zeros((s, t), dtype=np.int32)
    tri_c = np.zeros((s, t), dtype=np.int32)
    tri_up = np.zeros((s, t), dtype=bool)
    tri_valid = np.zeros((s, t), dtype=bool)
    n_tris = np.zeros(s, dtype=np.int32)
    for i, shape in enumerate(shapes):
        n_tris[i] = len(shape)
        for j, (r, c) in enumerate(shape):
            tri_r[i, j], tri_c[i, j] = r, c
            tri_up[i, j] = _is_up(r, c)
            tri_valid[i, j] = True
    return ShapeBank(
        tri_r=tri_r,
        tri_c=tri_c,
        tri_up=tri_up,
        tri_valid=tri_valid,
        n_tris=n_tris,
        shapes=shapes,
    )
