"""League / flywheel configuration: counterpart of
`alphatriangle_tpu/config/league_config.py`, field for field, with the
same defaults and bounds, so a JAX `LeagueConfig().model_dump()` loads
unchanged.

How many service lanes play matchmade games, how league data mixes with
self-play in the learner's diet, the weights-broadcast cadence, the
staleness window of the ingest guard, and the matchmaking and promotion
parameters (`league/`).
"""

from dataclasses import dataclass

from ._base import ConfigBase, check_range


@dataclass
class LeagueConfig(ConfigBase):
    """Flywheel-mode hyperparameters."""

    # --- Service sizing ---
    # Session slots of the league PolicyService.
    LEAGUE_SLOTS: int = 8
    # Games per side per pairing; the pairing's win fraction is the Elo
    # observation.
    GAMES_PER_ROUND: int = 4
    # Hard cap on moves per league game.
    MAX_GAME_MOVES: int = 200

    # --- Learner diet ---
    # Fraction of loop iterations that play a league round instead of a
    # self-play chunk (accumulated: 0.25 plays every 4th iteration).
    LEAGUE_MIX_RATIO: float = 0.25
    # Broadcast the learner's weights to the league service every N
    # learner steps.
    RELOAD_EVERY_STEPS: int = 8
    # Drop harvested rows whose weights trail the service's reload count
    # by more than this many reloads (None or negative: guard off).
    STALENESS_WINDOW: int | None = 4

    # --- Matchmaking ---
    # Elo-gap scale of the proximity kernel.
    MATCH_TEMPERATURE: float = 200.0
    # Uniform mass spread over the whole pool.
    EXPLORATION_FLOOR: float = 0.1
    ELO_K: float = 32.0

    # --- Promotion gate ---
    PROMOTION_MIN_GAMES: int = 4
    PROMOTION_WIN_RATE: float = 0.55

    def __post_init__(self) -> None:
        check_range("LEAGUE_SLOTS", self.LEAGUE_SLOTS, ge=1)
        check_range("GAMES_PER_ROUND", self.GAMES_PER_ROUND, ge=1)
        check_range("MAX_GAME_MOVES", self.MAX_GAME_MOVES, ge=1)
        check_range("LEAGUE_MIX_RATIO", self.LEAGUE_MIX_RATIO, ge=0.0, le=1.0)
        check_range("RELOAD_EVERY_STEPS", self.RELOAD_EVERY_STEPS, ge=1)
        check_range("MATCH_TEMPERATURE", self.MATCH_TEMPERATURE, gt=0.0)
        check_range("EXPLORATION_FLOOR", self.EXPLORATION_FLOOR, ge=0.0, le=1.0)
        check_range("ELO_K", self.ELO_K, gt=0.0)
        check_range("PROMOTION_MIN_GAMES", self.PROMOTION_MIN_GAMES, ge=1)
        check_range("PROMOTION_WIN_RATE", self.PROMOTION_WIN_RATE, ge=0.0, le=1.0)
        if self.GAMES_PER_ROUND > self.LEAGUE_SLOTS:
            raise ValueError(
                "GAMES_PER_ROUND cannot exceed LEAGUE_SLOTS "
                f"({self.GAMES_PER_ROUND} > {self.LEAGUE_SLOTS}): a round's "
                "games play in one set of service sessions."
            )
