"""Persistent league store: counterpart of `alphatriangle_tpu/league/pool.py`,
a crash-safe `league.jsonl` population of past checkpoints with Elo
ratings.

One append-only JSONL file per run holds the league's history as events,
record for record the JAX package's format, so each package reads the
other's file:

- ``{"kind": "member", ...}``    a checkpoint joins the pool
- ``{"kind": "result", ...}``    one finished pairing (win fraction)
- ``{"kind": "rating", ...}``    the Elo updates that result caused
- ``{"kind": "promotion", ...}`` the live net earned a pool seat

The in-memory state is a replay of the file: each mutation appends one
complete line before it updates memory, and the reader skips a torn last
line. Ratings use the incremental Elo update; `fit_elo` is the batch
Bradley-Terry fit.
"""

import json
import logging
import time
from pathlib import Path

import numpy as np

from ..telemetry.ledger import iter_jsonl_records

logger = logging.getLogger(__name__)

LEAGUE_FILENAME = "league.jsonl"

# The id of the training net in the pool's bookkeeping. It is never a
# member until promoted; a promotion mints `step_<n>`.
LIVE_ID = "live"

INITIAL_ELO = 0.0


def pairwise_win_fraction(scores_a, scores_b, paired: bool = False) -> float:
    """Win fraction of `a` over `b` from two score samples: element-wise
    when `paired` (same hands), else over all pairs; ties count half."""
    a = np.asarray(scores_a, dtype=np.float64)
    b = np.asarray(scores_b, dtype=np.float64)
    if a.size == 0 or b.size == 0:
        return 0.5
    d = a - b if paired and a.shape == b.shape else a[:, None] - b[None, :]
    return float((d > 0).mean() + 0.5 * (d == 0).mean())


def fit_elo(wins: np.ndarray, iters: int = 200, lr: float = 8.0) -> np.ndarray:
    """Batch Bradley-Terry fit in Elo units over a pairwise win-rate
    matrix (diagonal ignored); callers clip 0/1 win rates first."""
    n = wins.shape[0]
    elo = np.zeros(n)
    for _ in range(iters):
        expected = 1.0 / (1.0 + 10 ** ((elo[None, :] - elo[:, None]) / 400.0))
        np.fill_diagonal(expected, 0.0)
        elo += lr * (wins - expected).sum(axis=1)
        elo -= elo.mean()
    return elo


def elo_expected(ra: float, rb: float) -> float:
    return 1.0 / (1.0 + 10 ** ((rb - ra) / 400.0))


class LeaguePool:
    """The checkpoint population and its ratings, backed by `league.jsonl`
    and rebuilt from it at construction."""

    def __init__(self, path: "Path | str", elo_k: float = 32.0):
        self.path = Path(path)
        self.elo_k = float(elo_k)
        # member_id -> {"checkpoint": str, "step": int}
        self.members: dict[str, dict] = {}
        self.ratings: dict[str, float] = {}
        self.games: dict[str, int] = {}  # pairings played per id
        self.win_sum: dict[str, float] = {}  # cumulative win fraction
        self.promotions = 0
        self._replay()

    # --- persistence ------------------------------------------------------

    def _append(self, record: dict) -> None:
        record = {**record, "time": time.time()}
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with self.path.open("a") as f:
                f.write(json.dumps(record, default=str) + "\n")
                f.flush()
        except OSError:
            logger.exception("league append to %s failed", self.path)

    def _replay(self) -> None:
        if not self.path.exists():
            return
        for r in iter_jsonl_records(self.path):
            kind = r.get("kind")
            if kind == "member":
                self.members[r["member_id"]] = {"checkpoint": r.get("checkpoint"), "step": r.get("step")}
                self.ratings.setdefault(r["member_id"], float(r.get("elo", INITIAL_ELO)))
            elif kind == "result":
                self._fold_result(r["a"], r["b"], float(r["score_a"]), persist=False)
            elif kind == "promotion":
                self.promotions += 1
                # The live evidence window resets with a promotion, or a
                # resumed flywheel would promote again on spent evidence.
                self.games[LIVE_ID] = 0
                self.win_sum[LIVE_ID] = 0.0

    # --- membership -------------------------------------------------------

    def add_member(self, member_id: str, checkpoint: str, step: int, elo: float = INITIAL_ELO) -> None:
        """A checkpoint joins the opponent pool (idempotent by id)."""
        if member_id in self.members:
            return
        self.members[member_id] = {"checkpoint": checkpoint, "step": step}
        self.ratings.setdefault(member_id, float(elo))
        self._append(
            {
                "kind": "member",
                "member_id": member_id,
                "checkpoint": str(checkpoint),
                "step": int(step),
                "elo": float(self.ratings[member_id]),
            }
        )

    def member_ids(self) -> list[str]:
        return sorted(self.members, key=lambda m: self.members[m]["step"] or 0)

    def __len__(self) -> int:
        return len(self.members)

    # --- ratings ----------------------------------------------------------

    def rating(self, member_id: str) -> float:
        return self.ratings.get(member_id, INITIAL_ELO)

    def _fold_result(self, a: str, b: str, score_a: float, persist: bool) -> tuple[float, float]:
        """One pairing's incremental Elo update (`score_a`: a's win
        fraction over b). Returns the new (ra, rb)."""
        ra = self.ratings.get(a, INITIAL_ELO)
        rb = self.ratings.get(b, INITIAL_ELO)
        delta = self.elo_k * (score_a - elo_expected(ra, rb))
        self.ratings[a] = ra + delta
        self.ratings[b] = rb - delta
        self.games[a] = self.games.get(a, 0) + 1
        self.games[b] = self.games.get(b, 0) + 1
        self.win_sum[a] = self.win_sum.get(a, 0.0) + score_a
        self.win_sum[b] = self.win_sum.get(b, 0.0) + (1.0 - score_a)
        if persist:
            self._append({"kind": "result", "a": a, "b": b, "score_a": float(score_a)})
            for mid in (a, b):
                self._append(
                    {
                        "kind": "rating",
                        "member_id": mid,
                        "elo": round(self.ratings[mid], 3),
                        "games": self.games[mid],
                    }
                )
        return self.ratings[a], self.ratings[b]

    def record_result(self, a: str, b: str, score_a: float) -> tuple[float, float]:
        return self._fold_result(a, b, float(score_a), persist=True)

    def win_rate(self, member_id: str) -> "float | None":
        g = self.games.get(member_id, 0)
        if g == 0:
            return None
        return self.win_sum.get(member_id, 0.0) / g

    # --- promotion --------------------------------------------------------

    def maybe_promote(
        self, checkpoint: str, step: int, min_games: int, win_rate_gate: float, live_id: str = LIVE_ID
    ) -> "str | None":
        """Seat the live net in the pool when its win rate clears the
        gate over at least `min_games` pairings, then reset its window.
        Returns the new member id, or None."""
        games = self.games.get(live_id, 0)
        rate = self.win_rate(live_id)
        if games < min_games or rate is None or rate < win_rate_gate:
            return None
        member_id = f"step_{int(step):08d}"
        if member_id in self.members:
            return None
        self._append({"kind": "promotion", "member_id": member_id, "win_rate": round(rate, 4), "games": games})
        self.promotions += 1
        self.add_member(member_id, checkpoint, step, elo=self.rating(live_id))
        self.games[live_id] = 0
        self.win_sum[live_id] = 0.0
        return member_id
