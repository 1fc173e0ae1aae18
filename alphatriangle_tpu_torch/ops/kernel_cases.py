"""Adversarial inputs of the PER count and the backup, and the search
shapes of every path, built with numpy from a seed.

The CPU tests hold the plain versions to the JAX package on these
families, and the card tests and `chip_smoke.py` hold the CUDA kernels
to the plain versions on them. Each function returns numpy arrays; the
caller moves them to its device.

Count families (`count_case`): `cum` (n,) f32 and draws `u` (k, b) f32,
around the kernel's tiles of `TILE` elements: draws on tile edges,
ragged last tiles, `n` below a tile, runs of equal values across tiles,
NaN and +-inf in `cum` and in the draws, an unsorted `cum`, K = 8.

Backup families (`backup_case`): the four (B, N, A) planes and the
eight update operands of one wave: shared edges and inactive entries
on a few rows, every entry and insertion on one element, planes of -0.0
under inactive entries, W = 48 and W = 8 with D = 1 and D = 8, int32
indices, and a Gumbel wave (`gumbel_roots`: every member's depth-0
entry forced onto one of four root candidates, members of an
unexpanded candidate inserting under the root).

Search shapes (`SEARCH_SHAPES`, `gather_case`): the (B, N, A, W, D) of
the gather and the backup on the paths beyond the default search:
playout-cap fast searches (N = 17, W = 16), presets 2 and 4 (N = 201
and 401, W = 25) and preset 5's board (B = 1024, A = 756). The CPU
tests take them at a small B.
"""

import numpy as np

from .per_sample import TILE

COUNT_CASES = (
    "tile_edges", "ragged_above", "ragged_below", "short", "single", "constant_tiles",
    "nan_inf", "unsorted", "k8",
)
# Each backup family with its wave width W and depth D (None: the caller's).
BACKUP_CASES = {
    "random": (None, None),
    "one_element": (None, None),
    "negative_zero": (None, None),
    "w48_d8": (48, 8),
    "w48_d1": (48, 1),
    "w8_d8": (8, 8),
    "w8_d1": (8, 1),
    "int32": (None, None),
    "gumbel_roots": (None, None),
}
# (B, N, A, W, D) of a search on each new path: the node budget is the
# simulations + 1, W the largest divisor of the simulations <= 32.
SEARCH_SHAPES = {
    "fast": (512, 17, 360, 16, 8),  # preset 3's fast searches of 16
    "preset2": (128, 201, 360, 25, 8),  # 200 simulations
    "preset4": (512, 401, 360, 25, 8),  # 400 simulations
    "preset5": (1024, 65, 756, 32, 8),  # the 12x21 board, 3 slots
}


def gather_case(b: int, n: int, k: int, w: int, seed: int = 0):
    """(stats (B, N, K) f32, idx (B, W) int64) of one descent level; the
    first member of each game reads row N - 1, the last row 0."""
    pick = np.random.default_rng(seed)
    stats = pick.standard_normal((b, n, k), dtype=np.float32)
    idx = pick.integers(0, n, (b, w))
    idx[:, 0], idx[:, -1] = n - 1, 0
    return stats, idx.astype(np.int64)


def _draws(pick, cum: np.ndarray, fixed, k: int, b: int) -> np.ndarray:
    """(k, b) draws: `fixed` first, the rest uniform over [0, total)."""
    finite = cum[np.isfinite(cum)]
    top = float(finite.max()) if finite.size else 1.0
    u = (pick.random(k * b) * top).astype(np.float32)
    fixed = np.asarray(fixed, dtype=np.float32)[: k * b]
    u[: fixed.size] = fixed
    return u.reshape(k, b)


def _sorted_cum(pick, n: int) -> np.ndarray:
    return np.cumsum(pick.random(n).astype(np.float32), dtype=np.float32)


def count_case(name: str, seed: int = 0, n_large: int = 250_000):
    """(cum, u) of one count family; `k8` has `n_large` priorities."""
    pick = np.random.default_rng(seed)
    k, b = 2, 64
    if name == "tile_edges":
        cum = _sorted_cum(pick, 8 * TILE)
        edges = np.arange(TILE, 8 * TILE, TILE)
        fixed = np.concatenate([cum[edges - 1], cum[edges], cum[[0, -1]]])
        fixed = np.concatenate([fixed, np.nextafter(fixed, np.float32(np.inf))])
    elif name in ("ragged_above", "ragged_below", "short", "single"):
        n = {"ragged_above": 4 * TILE + 1, "ragged_below": 4 * TILE - 1, "short": TILE - 3,
             "single": 1}[name]
        cum = _sorted_cum(pick, n)
        above = np.nextafter(cum[-1], np.float32(np.inf))
        fixed = [cum[-1], cum[0], cum[n // 2], above, 0.0]
    elif name == "constant_tiles":
        p = pick.random(8 * TILE).astype(np.float32)
        p[2 * TILE + 100 : 5 * TILE + 7] = 0.0  # zero priorities: flat over 3 tiles
        cum = np.cumsum(p, dtype=np.float32)
        flat = cum[3 * TILE]
        fixed = [flat, np.nextafter(flat, np.float32(np.inf)),
                 np.nextafter(flat, np.float32(-np.inf)), cum[-1]]
    elif name == "nan_inf":
        cum = _sorted_cum(pick, 4 * TILE)
        cum[TILE + 5 : TILE + 9] = np.nan
        cum[TILE + 20] = np.inf
        cum[TILE + 30] = -np.inf
        cum[3 * TILE + 1] = np.nan
        fixed = [np.nan, np.inf, -np.inf, cum[TILE + 10], cum[TILE], np.nan]
    elif name == "unsorted":
        cum = pick.standard_normal(9000).astype(np.float32)
        cum[17], cum[4000], cum[4001] = np.nan, np.inf, -np.inf
        u = pick.standard_normal((k, b)).astype(np.float32)
        u[1, 2], u[0, 3], u[0, 4] = np.nan, np.inf, -np.inf
        return cum, u
    elif name == "k8":
        p = pick.random(n_large).astype(np.float32) * 2.0
        p[n_large // 3 : n_large // 3 + n_large // 10] = 0.0  # empty slots
        cum = np.cumsum(p, dtype=np.float32)
        k, b = 8, 256
        fixed = [cum[n_large // 3], cum[-1]]
    else:
        raise ValueError(f"unknown count case: {name!r}")
    return cum, _draws(pick, cum, fixed, k, b)


def backup_case(name: str, b: int, n: int, a: int, seed: int = 0, w: int = 32, d: int = 8):
    """(planes, updates) of one backup family at B = `b` games of N = `n`
    rows and A = `a` actions; `w` and `d` apply where the family names
    none. Planes: e_visits, e_value, children, e_reward; updates:
    parents, actions, new_child, rewards, rec_node, rec_action,
    rec_active (bool), returns."""
    fam_w, fam_d = BACKUP_CASES[name]
    w, d = fam_w or w, fam_d or d
    pick = np.random.default_rng(seed)
    visits = pick.integers(0, 5, (b, n, a)).astype(np.float32)
    value = pick.standard_normal((b, n, a), dtype=np.float32)
    children = np.where(pick.random((b, n, a)) < 0.1, pick.integers(1, n, (b, n, a)), -1)
    children = children.astype(np.float32)
    reward = pick.standard_normal((b, n, a), dtype=np.float32)
    rows, acts = min(4, n), min(6, a)
    parents = pick.integers(0, rows, (b, w))
    actions = pick.integers(0, acts, (b, w))
    shared = len(range(1, w, 4))  # shared edges: member 4i + 1 repeats member 4i
    parents[:, 1::4], actions[:, 1::4] = parents[:, 0::4][:, :shared], actions[:, 0::4][:, :shared]
    new_child = np.where(pick.random((b, w)) < 0.5, pick.integers(1, n, (b, w)), -1)
    rewards = pick.standard_normal((b, w), dtype=np.float32)
    active = pick.random((b, w, d)) < 0.7
    node = pick.integers(0, rows, (b, w, d))
    action = pick.integers(0, acts, (b, w, d))
    returns = pick.standard_normal((b, w, d), dtype=np.float32)
    if name == "one_element":
        # Every insertion and every entry, active or not, on element (0, 0).
        parents[:], actions[:] = 0, 0
        node[:], action[:] = 0, 0
        active = pick.random((b, w, d)) < 0.9
    elif name == "negative_zero":
        # -0.0 planes; returns of -0.0 and +0.0; some elements reached only
        # by inactive entries (which keep their node and action).
        visits[:] = -0.0
        value[:] = np.where(pick.random((b, n, a)) < 0.8, np.float32(-0.0), value)
        returns = np.where(pick.random((b, w, d)) < 0.4, np.float32(-0.0), returns)
        returns = np.where(pick.random((b, w, d)) < 0.2, np.float32(0.0), returns)
        node, action = pick.integers(0, 2, (b, w, d)), pick.integers(0, 2, (b, w, d))
        active = pick.random((b, w, d)) < 0.5
        keep = active | (pick.random((b, w, d)) < 0.5)
        node, action = np.where(keep, node, -1), np.where(keep, action, -1)
    elif name == "gumbel_roots":
        # Member j's depth-0 action is forced to candidate j % 4; paths of
        # 1..D levels; a member whose path ends at the root inserts under
        # it, on its candidate's edge.
        roots = pick.choice(a, min(4, a), replace=False)[np.arange(w) % min(4, a)]
        length = pick.integers(1, d + 1, (b, w))
        active = np.arange(d)[None, None, :] < length[:, :, None]
        node[:, :, 0], action[:, :, 0] = 0, roots[None, :]
        at_root = length == 1
        parents = np.where(at_root, 0, parents)
        actions = np.where(at_root, roots[None, :], actions)
    if name != "negative_zero":
        node, action = np.where(active, node, -1), np.where(active, action, -1)
    index = np.int32 if name == "int32" else np.int64
    planes = (visits, value, children, reward)
    updates = (
        parents.astype(index), actions.astype(index), new_child.astype(np.float32), rewards,
        node.astype(index), action.astype(index), active, returns.astype(np.float32),
    )
    return planes, updates
