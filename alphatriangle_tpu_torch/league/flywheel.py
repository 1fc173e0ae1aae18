"""Flywheel loop mode: counterpart of `alphatriangle_tpu/league/flywheel.py`.
The learner and matchmade league games in one process.

The synchronous training loop keeps its rollout -> learn cadence, but a
fraction of its iterations (`LEAGUE_MIX_RATIO`, accumulated) plays a
round of league games through a `PolicyService` instead of a self-play
chunk. Each round:

    broadcast live weights -> the live net plays G games (emitter on)
    matchmaker samples an opponent -> it plays G games (emitter off)
    win fraction -> pool Elo update (league.jsonl)
    promotion gate -> the live net checkpoints into the pool
    emitter drain -> staleness guard -> replay ring (_fold_result)

The live side's served games are harvested by the `TrajectoryEmitter`
and folded through the loop's own `_fold_result`, so the ring ingests
them as it ingests self-play. The service owns a `NeuralNetwork` of its
own on the same device (seed + 7), whose weights swap every half-round
(`reload_weights`, which also makes a reduced-precision service cast the
new weights): sharing the learner's net would let an opponent's weights
reach self-play. Pool members restore through
`CheckpointManager.restore_path`, which leaves the learner untouched;
a member the port cannot read (a JAX Orbax step directory, a pruned
step) raises with its path.

Each round appends one `kind:"league"` record, the JAX package's fields
(and the live side's moves, `live_moves`), to `round_records` and to the
run's metrics ledger (`metrics.jsonl`, `cli perf`'s league summary);
its `mean_staleness` and `weight_reloads` read the service's reload
clock, as the JAX record does. The league run has the training run's
telemetry: heartbeat, util records, flight ring, anomaly screen, and
one `kind:"device_stats"` record an iteration, whose serve leg folds
the league service's stat-packs (the JAX flywheel leaves those in the
service's window).
`Stats/stale_dropped` goes to the run's `StatsCollector` as in the JAX
loop.
"""

import logging
import time

import numpy as np

from ..training.loop import TrainingLoop
from .emitter import TrajectoryEmitter, apply_staleness_guard
from .matchmaker import Matchmaker
from .pool import LEAGUE_FILENAME, LIVE_ID, LeaguePool, pairwise_win_fraction

logger = logging.getLogger(__name__)


def member_variables(checkpoints, checkpoint_path, template: dict) -> dict:
    """The state dict of a pool member's checkpoint, restored without
    touching the learner: `template` (a state dict of the serving net)
    with the checkpoint's parameters and, under batch norm, its running
    statistics. Raises with the path when the port cannot read it."""
    try:
        loaded = checkpoints.restore_path(str(checkpoint_path))
    except Exception as exc:
        raise FileNotFoundError(f"league member checkpoint unreadable: {checkpoint_path} ({exc})") from exc
    if loaded.train_state is None:
        raise FileNotFoundError(f"league member checkpoint unreadable: {checkpoint_path}")
    state = dict(template)
    for part in ("params", "batch_stats"):
        for name, tensor in loaded.train_state.get(part, {}).items():
            if name not in state:
                raise ValueError(f"league member {checkpoint_path}: {part}[{name}] is not in the net")
            state[name] = tensor
    return state


class FlywheelLoop(TrainingLoop):
    """`TrainingLoop` whose synchronous iterations interleave league
    rounds (`run_flywheel` refuses the overlapped and megastep modes: a
    round drives the service between learner steps on one thread)."""

    def __init__(self, components, league_config, service, emitter: TrajectoryEmitter, pool: LeaguePool,
                 matchmaker: Matchmaker):
        super().__init__(components)
        self.league = league_config
        self.service = service
        self.emitter = emitter
        self.pool = pool
        self.matchmaker = matchmaker
        self._mix_acc = 0.0
        self.league_rounds = 0
        self.league_moves_ingested = 0
        self.stale_dropped_total = 0
        self.round_records: list[dict] = []
        self.timings["league_round_s"] = []
        # The learner's weights served in league rounds, copied afresh
        # once RELOAD_EVERY_STEPS learner steps have passed.
        self._live_vars: "dict | None" = None
        self._live_vars_step: "int | None" = None
        # member_id -> restored state dict (at most 4 kept).
        self._opp_cache: dict = {}

    # --- weights ---------------------------------------------------------

    def _live_variables(self) -> dict:
        """A copy of the learner's state dict (the learner updates its
        tensors in place at its next step)."""
        step = self.global_step
        if self._live_vars is None or step - self._live_vars_step >= self.league.RELOAD_EVERY_STEPS:
            self._live_vars = {k: v.detach().clone() for k, v in self.c.trainer.get_variables().items()}
            self._live_vars_step = step
        return self._live_vars

    def _member_variables(self, member_id: str) -> dict:
        if member_id not in self._opp_cache:
            if len(self._opp_cache) >= 4:
                self._opp_cache.pop(next(iter(self._opp_cache)))
            self._opp_cache[member_id] = member_variables(
                self.c.checkpoints, self.pool.members[member_id]["checkpoint"],
                self.service.net.model.state_dict(),
            )
        return self._opp_cache[member_id]

    # --- one league round -------------------------------------------------

    def _league_round(self) -> int:
        """One matchmade pairing through the service; the live side's
        trajectories fold into the ring. Returns the rows ingested."""
        from ..arena import play_service

        league = self.league
        svc = self.service
        t0 = time.perf_counter()
        seed = self.cfg.RANDOM_SEED + 9001 + 2 * self.league_rounds

        # Live half: the learner's weights, the emitter harvesting.
        svc.reload_weights(self._live_variables())
        svc.emitter = self.emitter
        try:
            live_scores, live_lengths, _ = play_service(svc, league.GAMES_PER_ROUND, league.MAX_GAME_MOVES, seed)
        finally:
            svc.emitter = None

        # Opponent half: a matchmade past checkpoint, not harvested (its
        # visit policies would train the live net toward an old net).
        opponent = self.matchmaker.sample_opponent()
        svc.reload_weights(self._member_variables(opponent))
        opp_scores, _, _ = play_service(svc, league.GAMES_PER_ROUND, league.MAX_GAME_MOVES, seed + 1)

        win_fraction = pairwise_win_fraction(live_scores, opp_scores)
        self.pool.record_result(LIVE_ID, opponent, win_fraction)
        promoted = self._maybe_promote()

        harvest = self.emitter.drain()
        harvest, dropped = apply_staleness_guard(harvest, svc.weight_reloads, league.STALENESS_WINDOW)
        self.stale_dropped_total += dropped
        buffer_before = len(self.c.buffer)
        added = self._fold_result(harvest) if harvest is not None else 0
        self.league_rounds += 1
        self.league_moves_ingested += added
        self.c.stats.log_scalar("Stats/stale_dropped", self.stale_dropped_total, self.global_step)
        dt = max(1e-9, time.perf_counter() - t0)
        self.timings["league_round_s"].append(dt)
        clock = svc.weight_reloads
        versions = harvest.context.get("row_versions", []) if harvest else []
        record = {
            "kind": "league",
            "time": time.time(),
            "step": self.global_step,
            "round": self.league_rounds,
            "pool_size": len(self.pool),
            "opponent": opponent,
            "opponent_mix": self.matchmaker.opponent_mix(),
            "win_fraction": round(float(win_fraction), 4),
            "live_elo": round(self.pool.rating(LIVE_ID), 3),
            "promoted": promoted,
            "promotions": self.pool.promotions,
            "live_moves": int(np.sum(live_lengths)),
            "moves_ingested": added,
            "ingested_moves_per_sec": round(added / dt, 2),
            "stale_dropped": dropped,
            "stale_dropped_total": self.stale_dropped_total,
            "mean_staleness": round(clock - sum(versions) / len(versions), 3) if versions else None,
            "weight_reloads": clock,
            "buffer_size_before": buffer_before,
            "buffer_size_after": len(self.c.buffer),
        }
        self.round_records.append(record)
        if self.telemetry.ledger is not None:
            self.telemetry.ledger.append(record)
        logger.info(
            "League round %d: live %.2f vs %s (elo %.1f vs %.1f), %d rows ingested%s.",
            self.league_rounds, win_fraction, opponent, self.pool.rating(LIVE_ID),
            self.pool.rating(opponent), added, f", PROMOTED {promoted}" if promoted else "",
        )
        return added

    def _maybe_promote(self) -> "str | None":
        """Checkpoint the live net and seat it in the pool when its win
        rate clears the gate (checked first, before the forced save the
        seat points at). The save is committed, marker included, before
        the pool records the member."""
        league = self.league
        rate = self.pool.win_rate(LIVE_ID)
        if (
            self.pool.games.get(LIVE_ID, 0) < league.PROMOTION_MIN_GAMES
            or rate is None
            or rate < league.PROMOTION_WIN_RATE
        ):
            return None
        step = self.global_step
        self._maybe_checkpoint(force=True)
        checkpoint = self.c.persistence_config.get_checkpoint_dir().resolve() / f"step_{step:08d}"
        return self.pool.maybe_promote(
            str(checkpoint), step, league.PROMOTION_MIN_GAMES, league.PROMOTION_WIN_RATE
        )

    # --- the mixed loop ---------------------------------------------------

    def _drain_device_stats(self) -> "dict | None":
        """The loop's stat-pack fold, plus the league service's
        dispatches since the last iteration as its serve leg (a league
        round's searches are the service's)."""
        ds = super()._drain_device_stats()
        leg = self.service.take_device_stats()
        if leg:
            ds = {**(ds or {}), "serve": leg}
        return ds

    def _process_rollout(self) -> int:
        """The synchronous loop's rollout: a league round when the mix
        accumulator is due and the pool holds an opponent (RATIO 0.25
        plays one every 4th iteration, 1.0 every one), else a self-play
        chunk."""
        self._mix_acc += self.league.LEAGUE_MIX_RATIO
        if self._mix_acc >= 1.0 and len(self.pool) > 0:
            self._mix_acc -= 1.0
            return self._league_round()
        return super()._process_rollout()

    def report(self) -> dict:
        rounds = self.timings["league_round_s"]
        return {
            **super().report(),
            "league_rounds": self.league_rounds,
            "league_moves_ingested": self.league_moves_ingested,
            "league_live_moves": sum(r["live_moves"] for r in self.round_records),
            "stale_dropped": self.stale_dropped_total,
            "league_round_s": rounds,
            "league_rounds_per_s": len(rounds) / sum(rounds) if rounds else None,
            "league_ingested_moves_per_s": self.league_moves_ingested / sum(rounds) if rounds else None,
            "league_dispatches": self.service.dispatch_count,
            "league_dispatch_ms_p50": self.service.serve_stats(drain=False)["serve_batch_ms_p50"],
        }


def seed_pool_from_run(pool: LeaguePool, persistence_config, run_name: str) -> int:
    """Seed the pool with every checkpoint of run `run_name` under ids
    `<run>:step_<n>` (a promotion mints bare `step_<n>`). Returns the
    members added."""
    from ..stats.persistence import CheckpointManager

    src = persistence_config.model_copy(update={"RUN_NAME": run_name})
    mgr = CheckpointManager(src, create_dirs=False)
    before = len(pool)
    ckpt_dir = src.get_checkpoint_dir().resolve()
    for step in mgr.list_steps():
        pool.add_member(f"{run_name}:step_{step:08d}", str(ckpt_dir / f"step_{step:08d}"), step)
    return len(pool) - before


def run_flywheel(
    train_config=None,
    league_config=None,
    env_config=None,
    model_config=None,
    mcts_config=None,
    persistence_config=None,
    pool_from: "str | None" = None,
    device=None,
    use_tensorboard: bool = False,
    telemetry_config=None,
) -> "FlywheelLoop | None":
    """Run a flywheel session (`cli league`) on `device` (CUDA unless
    named): `run_training`'s setup, restore, SIGTERM handling and
    teardown, so a flywheel run's checkpoints resume under `cli train`,
    plus the league pool (`league.jsonl` in the run directory, seeded
    from `pool_from`'s checkpoints), a `PolicyService` over a net of its
    own and the emitter. Returns the finished loop, or None when the
    config is refused (overlapped or megastep mode, an empty pool)."""
    from ..config.league_config import LeagueConfig
    from ..config.persistence_config import PersistenceConfig
    from ..config.train_config import TrainConfig
    from ..mcts import BatchedMCTS
    from ..nn.network import NeuralNetwork
    from ..serving import PolicyService
    from ..training.loop import LoopStatus
    from ..training.runner import _install_preempt_handler, _resolve_auto_resume, _restore
    from ..training.setup import setup_training_components

    train_config = train_config or TrainConfig()
    league_config = league_config or LeagueConfig()
    if train_config.FUSED_MEGASTEP or train_config.ASYNC_ROLLOUTS:
        logger.error(
            "Flywheel mode composes with the synchronous loop only; disable FUSED_MEGASTEP/ASYNC_ROLLOUTS."
        )
        return None
    persistence_config = persistence_config or PersistenceConfig(RUN_NAME=train_config.RUN_NAME)
    train_config, persistence_config = _resolve_auto_resume(train_config, persistence_config)
    c = setup_training_components(
        train_config=train_config,
        env_config=env_config,
        model_config=model_config,
        mcts_config=mcts_config,
        persistence_config=persistence_config,
        device=device,
        use_tensorboard=use_tensorboard,
        telemetry_config=telemetry_config,
    )
    try:
        pool = LeaguePool(c.persistence_config.get_run_base_dir() / LEAGUE_FILENAME, elo_k=league_config.ELO_K)
        if pool_from:
            added = seed_pool_from_run(pool, c.persistence_config, pool_from)
            logger.info(
                "League pool: seeded %d member(s) from run '%s' (%d total).", added, pool_from, len(pool)
            )
        if len(pool) == 0:
            logger.error(
                "League pool is empty: pass --pool-from a run with checkpoints (matchmaking needs "
                "at least one opponent)."
            )
            return None
        matchmaker = Matchmaker(
            pool,
            temperature=league_config.MATCH_TEMPERATURE,
            exploration_floor=league_config.EXPLORATION_FLOOR,
            seed=train_config.RANDOM_SEED,
        )
        serve_net = NeuralNetwork(c.model_config, c.env_config, seed=train_config.RANDOM_SEED + 7, device=c.device)
        serve_mcts = BatchedMCTS(c.env, c.extractor, serve_net.model, c.mcts_config, serve_net.support)
        service = PolicyService(
            c.env, c.extractor, serve_net, serve_mcts, slots=league_config.LEAGUE_SLOTS,
            rng_seed=train_config.RANDOM_SEED + 11,
        )
        emitter = TrajectoryEmitter(c.env, c.extractor, gamma=train_config.GAMMA)
        loop = FlywheelLoop(c, league_config, service, emitter, pool, matchmaker)
        t0 = time.perf_counter()
        try:
            _restore(loop)
        except Exception as exc:
            logger.exception(
                "State restore failed for run '%s'; aborting rather than writing a fresh model "
                "into its run directory.",
                persistence_config.RUN_NAME,
            )
            loop.error, loop.status = exc, LoopStatus.ERROR
            return loop
        loop.restore_s = time.perf_counter() - t0
        undo = _install_preempt_handler(loop)
        try:
            status = loop.run()
        finally:
            undo()
    finally:
        c.stats.close()
    logger.info(
        "Flywheel finished: %s (%d league rounds, %d moves ingested, %d promotion(s), pool %d).",
        status.value, loop.league_rounds, loop.league_moves_ingested, pool.promotions, len(pool),
    )
    return loop
