"""Planar geometry: counterpart of `alphatriangle_tpu/utils/geometry.py`.

Kept for visualization tooling; not on the training path.
"""


def is_point_in_polygon(point: tuple, polygon: list) -> bool:
    """Ray-casting point-in-polygon test (the boundary counts as inside)."""
    x, y = point
    n = len(polygon)
    if n < 3:
        return False
    inside = False
    j = n - 1
    for i in range(n):
        xi, yi = polygon[i]
        xj, yj = polygon[j]
        if (xi, yi) == (x, y):  # on a vertex
            return True
        # On a horizontal edge: the crossing test below skips edges with
        # yi == yj, so points lying on them need this check.
        if yi == yj == y and min(xi, xj) <= x <= max(xi, xj):
            return True
        if (yi > y) != (yj > y):
            x_cross = (xj - xi) * (y - yi) / (yj - yi) + xi
            if abs(x - x_cross) < 1e-12:
                return True
            if x < x_cross:
                inside = not inside
        j = i
    return inside
