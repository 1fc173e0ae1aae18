"""Rating-proximity matchmaking with an exploration floor: counterpart
of `alphatriangle_tpu/league/matchmaker.py`.

Most league games go to opponents near the live net's rating; a uniform
floor keeps every member in rotation. The draws come from a NumPy
generator of the seed, so one seed draws the JAX package's opponents.
"""

import numpy as np

from .pool import LIVE_ID, LeaguePool


class Matchmaker:
    """Samples opponents for the live net from a `LeaguePool`."""

    def __init__(
        self, pool: LeaguePool, temperature: float = 200.0, exploration_floor: float = 0.1, seed: int = 0
    ):
        self.pool = pool
        # A gap of one `temperature` decays the preference by e^-1.
        self.temperature = max(1e-6, float(temperature))
        self.exploration_floor = min(1.0, max(0.0, float(exploration_floor)))
        self._rng = np.random.default_rng(seed)
        self.opponent_counts: dict[str, int] = {}

    def probabilities(self, live_rating: "float | None" = None) -> dict:
        """The sampling distribution over pool members."""
        ids = self.pool.member_ids()
        if not ids:
            return {}
        if live_rating is None:
            live_rating = self.pool.rating(LIVE_ID)
        gaps = np.array([abs(self.pool.rating(m) - live_rating) for m in ids])
        prox = np.exp(-gaps / self.temperature)
        total = prox.sum()
        prox = prox / total if total > 0 else np.full(len(ids), 1.0 / len(ids))
        floor = self.exploration_floor
        probs = (1.0 - floor) * prox + floor / len(ids)
        return dict(zip(ids, probs))

    def sample_opponent(self, live_rating: "float | None" = None) -> str:
        """One opponent id; raises on an empty pool."""
        probs = self.probabilities(live_rating)
        if not probs:
            raise RuntimeError("Matchmaker: the league pool is empty; add members first.")
        ids = list(probs)
        member = ids[self._rng.choice(len(ids), p=np.asarray(list(probs.values())))]
        self.opponent_counts[member] = self.opponent_counts.get(member, 0) + 1
        return member

    def opponent_mix(self) -> dict:
        """Cumulative opponent-selection histogram."""
        return dict(self.opponent_counts)
