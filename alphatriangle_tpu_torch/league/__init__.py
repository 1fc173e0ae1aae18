"""League subsystem: counterpart of `alphatriangle_tpu/league/`, the
experience flywheel (served games into replay).

The trajectory emitter harvests (features, visit policy, outcome) rows
from `PolicyService` dispatches with staleness tags; the pool and the
matchmaker keep a crash-safe `league.jsonl` population of past
checkpoints with Elo ratings and proximity-weighted opponent draws; the
flywheel loop interleaves matchmade league games with self-play into one
learner.
"""

from .emitter import TrajectoryEmitter, apply_staleness_guard, merge_results
from .matchmaker import Matchmaker
from .pool import (
    INITIAL_ELO,
    LEAGUE_FILENAME,
    LIVE_ID,
    LeaguePool,
    elo_expected,
    fit_elo,
    pairwise_win_fraction,
)

__all__ = [
    "INITIAL_ELO",
    "LEAGUE_FILENAME",
    "LIVE_ID",
    "FlywheelLoop",
    "LeaguePool",
    "Matchmaker",
    "TrajectoryEmitter",
    "apply_staleness_guard",
    "elo_expected",
    "fit_elo",
    "merge_results",
    "pairwise_win_fraction",
    "run_flywheel",
]


def __getattr__(name):
    # The flywheel imports the training loop; the pool, matchmaker and
    # emitter stay importable without it.
    if name in ("FlywheelLoop", "run_flywheel"):
        from . import flywheel

        return getattr(flywheel, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
