"""Array-backed sum tree of the PER priorities: a NumPy copy of
`alphatriangle_tpu/utils/sumtree.py` (the port imports nothing of the JAX
package, not even its NumPy modules).

The megastep samples on the card (`ops.per_sample`) and keeps the tree
as the host mirror of its device priorities: `update_batch` (duplicates
last-write-wins), `total_priority`, `max_priority`, the leaf layout and
the ring counters. The synchronous and overlapped loops sample on the
host: `add` / `add_batch` insert at the ring pointer, `get_leaf(s)`
descend by prefix sums and `sample_batch` draws stratified slots from a
`np.random.Generator`, exactly as the JAX tree does for the same draws.

Layout: capacity is rounded up to a power of two; `self.tree` stores
internal nodes in [1, cap) and leaves in [cap, 2*cap) (1-indexed heap).
"""

import numpy as np


class SumTree:
    """Array sum tree over `capacity` priority slots."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._cap2 = 1 << (capacity - 1).bit_length()  # power-of-two leaf count
        self.tree = np.zeros(2 * self._cap2, dtype=np.float64)
        self.data: list = [None] * capacity
        self.data_pointer = 0  # ring pointer over [0, capacity)
        self.n_entries = 0
        self._max_priority_seen = 1.0

    # --- writes -----------------------------------------------------------

    def add(self, priority: float, data) -> int:
        """Insert at the ring pointer; returns the slot index used."""
        idx = self.data_pointer
        self.data[idx] = data
        self.update(idx, priority)
        self.data_pointer = (self.data_pointer + 1) % self.capacity
        self.n_entries = min(self.n_entries + 1, self.capacity)
        return idx

    def add_batch(self, priorities: np.ndarray, items: list) -> np.ndarray:
        """Ring-insert a batch; returns slot indices (vectorized update)."""
        k = len(items)
        idxs = (self.data_pointer + np.arange(k)) % self.capacity
        for i, item in zip(idxs, items):
            self.data[int(i)] = item
        self.update_batch(idxs, np.asarray(priorities, dtype=np.float64))
        self.data_pointer = int((self.data_pointer + k) % self.capacity)
        self.n_entries = min(self.n_entries + k, self.capacity)
        return idxs

    def update(self, idx: int, priority: float) -> None:
        self.update_batch(np.asarray([idx]), np.asarray([priority]))

    def update_batch(self, idxs: np.ndarray, priorities: np.ndarray) -> None:
        """Set priorities for slots `idxs`, propagating sums level-by-level.

        Duplicate indices are resolved last-write-wins before propagation
        (the reference's sequential loop has the same net effect).
        """
        idxs = np.asarray(idxs, dtype=np.int64)
        priorities = np.asarray(priorities, dtype=np.float64)
        if len(idxs) == 0:
            return
        if np.any(priorities < 0) or not np.all(np.isfinite(priorities)):
            raise ValueError("priorities must be finite and non-negative")
        # Last-write-wins dedupe.
        if len(idxs) > 1:
            _, last = np.unique(idxs[::-1], return_index=True)
            keep = len(idxs) - 1 - last
            idxs, priorities = idxs[keep], priorities[keep]
        self._max_priority_seen = max(
            self._max_priority_seen, float(priorities.max(initial=0.0))
        )
        nodes = idxs + self._cap2
        self.tree[nodes] = priorities
        nodes = np.unique(nodes >> 1)
        while nodes[0] >= 1:
            left = self.tree[2 * nodes]
            right = self.tree[2 * nodes + 1]
            self.tree[nodes] = left + right
            if nodes[0] == 1:
                break
            nodes = np.unique(nodes >> 1)

    # --- reads ------------------------------------------------------------

    @property
    def total_priority(self) -> float:
        return float(self.tree[1])

    @property
    def max_priority(self) -> float:
        """Max priority ever seen (1.0 before any update), for new-item init."""
        return float(self._max_priority_seen)

    def get_leaf(self, value: float) -> tuple[int, float, object]:
        """Prefix-sum descent for one value -> (slot, priority, data)."""
        idx, prio = self.get_leaves(np.asarray([value]))
        i = int(idx[0])
        return i, float(prio[0]), self.data[i]

    def get_leaves(self, values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized descent: (K,) prefix values -> (slots, priorities)."""
        values = np.asarray(values, dtype=np.float64).copy()
        if len(values) == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64)
        nodes = np.ones(len(values), dtype=np.int64)
        while nodes[0] < self._cap2:
            left = 2 * nodes
            left_sum = self.tree[left]
            go_right = values > left_sum
            values = np.where(go_right, values - left_sum, values)
            nodes = np.where(go_right, left + 1, left)
        slots = nodes - self._cap2
        # Float drift can land a descent on an empty slot past the entries.
        slots = np.clip(slots, 0, max(self.n_entries - 1, 0))
        return slots, self.tree[slots + self._cap2]

    def sample_batch(self, k: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
        """Stratified proportional sampling of k slots -> (slots, priorities)."""
        total = self.total_priority
        if total <= 0 or self.n_entries == 0:
            raise ValueError("cannot sample from an empty tree")
        edges = np.linspace(0.0, total, k + 1)
        values = rng.uniform(edges[:-1], edges[1:])
        return self.get_leaves(values)

    def __len__(self) -> int:
        return self.n_entries
