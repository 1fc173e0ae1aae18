"""Array-backed sum tree of the PER priorities: the host mirror of the
device priority array, a NumPy copy of the write and read side of
`alphatriangle_tpu/utils/sumtree.py` (the port imports nothing of the JAX
package, not even its NumPy modules).

The port samples on the card (`ops.per_sample`), so the mirror keeps
only what the device ring reads and writes: `update_batch` (duplicates
last-write-wins), `total_priority`, `max_priority`, the leaf layout and
the ring counters, which `DeviceReplayBuffer` advances.

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
        self.data_pointer = 0  # ring pointer over [0, capacity)
        self.n_entries = 0
        self._max_priority_seen = 1.0

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

    @property
    def total_priority(self) -> float:
        return float(self.tree[1])

    @property
    def max_priority(self) -> float:
        """Max priority ever seen (1.0 before any update), for new-item init."""
        return float(self._max_priority_seen)

    def __len__(self) -> int:
        return self.n_entries
