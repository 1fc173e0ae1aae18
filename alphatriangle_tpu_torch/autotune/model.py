"""The autotuner's throughput model and its calibration from a run's
records: counterpart of `alphatriangle_tpu/autotune/model.py`.

The search maximizes PREDICTED games an hour, composed without running
a candidate:

- model FLOPs a lane-move: one network forward a simulation's leaf (and
  about one root evaluation a move), playout-cap randomization folded
  into an expected simulation count, plus the learner's share of a step
  (each row consumed once: `train_step_flops / BATCH_SIZE`); the FLOPs
  of `utils/flops.py`, the same account the run's `UtilizationMeter`
  keeps, so a prediction and an observation share a currency;
- compute time: FLOPs / (efficiency x peak bf16 FLOP/s x dp), the
  efficiency being the achieved MFU of earlier runs when `--calibrate`
  names them;
- dispatch overhead: a constant a host dispatch, spread over the chunk
  T; the fused megastep is one dispatch an iteration, a synchronous
  iteration `2 + ceil(B*T/(lbatch*K))`.

The model is monotone non-decreasing in B, T and K (the dominance prune
relies on B), and BUFFER_CAPACITY is absent: a ring costs memory, not
time. Stdlib only.
"""

import logging
import math
from dataclasses import dataclass, field

from ..utils.flops import forward_flops, train_step_flops

logger = logging.getLogger(__name__)

# The achieved-MFU prior when no history is named. The reference's value,
# kept for parity (the parity tests compare calibrations built on it);
# it is no measurement of any card. `--calibrate` replaces it.
DEFAULT_EFFICIENCY = 0.014

# Seconds of host work a dispatch costs. The reference's constant, kept
# for parity, no measurement of any card; calibration cannot observe it.
DEFAULT_DISPATCH_OVERHEAD_S = 0.01

# The peak assumed when the device is unknown (the CPU): it only ranks
# candidates against each other, which share the denominator.
FALLBACK_PEAK_TFLOPS = 1.0


@dataclass
class Calibration:
    """Terms of the throughput model learned from earlier runs.

    `efficiency` is achieved MFU; `moves_per_game` converts moves/s to
    games/h; `outcome_scale` multiplies predictions by the observed /
    predicted ratio of earlier tuned runs (`kind:"tune_outcome"`
    records); `family_seconds` is the measured p50 dispatch wall per
    program family from a run's flight ring; `cost_flops` the FLOPs a
    dispatch per family from its cost records (analytic in the port,
    telemetry/roofline.py), which anchor `efficiency` when both are
    there; `sources` says where each term came from."""

    efficiency: float = DEFAULT_EFFICIENCY
    moves_per_game: "float | None" = None
    overhead_s: float = DEFAULT_DISPATCH_OVERHEAD_S
    outcome_scale: float = 1.0
    family_seconds: dict = field(default_factory=dict)
    cost_flops: dict = field(default_factory=dict)
    sources: list = field(default_factory=lambda: ["defaults"])

    def as_dict(self) -> dict:
        return {
            "efficiency": self.efficiency,
            "moves_per_game": self.moves_per_game,
            "overhead_s_per_dispatch": self.overhead_s,
            "outcome_scale": self.outcome_scale,
            "family_seconds": dict(self.family_seconds),
            "cost_flops": dict(self.cost_flops),
            "sources": list(self.sources),
        }


def _num(x) -> bool:
    return isinstance(x, (int, float))


def default_moves_per_game(env_config) -> float:
    """A geometry prior for a game's length: playable cells over the
    average shape's triangles (at least 2)."""
    playable = sum(hi - lo for lo, hi in env_config.PLAYABLE_RANGE_PER_ROW)
    avg_shape = max(1.0, (env_config.MIN_SHAPE_TRIANGLES + env_config.MAX_SHAPE_TRIANGLES) / 2.0)
    return max(2.0, playable / avg_shape)


def expected_simulations(mcts_config) -> float:
    """Expected simulations a move under playout-cap randomization (full
    searches with probability p, fast ones otherwise)."""
    full = float(mcts_config.max_simulations)
    fast = getattr(mcts_config, "fast_simulations", None)
    if not fast:
        return full
    p = float(getattr(mcts_config, "full_search_prob", 0.25) or 0.25)
    return p * full + (1.0 - p) * float(fast)


def calibration_from_summary(summary: dict) -> "Calibration | None":
    """Calibration terms from one perf summary (`load_comparable`'s), or
    None when it carries nothing usable."""
    if not isinstance(summary, dict):
        return None
    terms: dict = {}
    mfu = summary.get("mfu")
    if _num(mfu) and 0 < mfu <= 1:
        terms["efficiency"] = float(mfu)
    moves_s = summary.get("moves_per_sec")
    games_h = summary.get("games_per_hour")
    if _num(moves_s) and _num(games_h) and moves_s > 0 and games_h > 0:
        terms["moves_per_game"] = moves_s * 3600.0 / games_h
    if not terms:
        return None
    return Calibration(
        efficiency=terms.get("efficiency", DEFAULT_EFFICIENCY),
        moves_per_game=terms.get("moves_per_game"),
        sources=[str(summary.get("source", "summary"))],
    )


def merge_calibrations(calibrations: list) -> Calibration:
    """One calibration from several: the arithmetic mean of each term."""
    cals = [c for c in calibrations if isinstance(c, Calibration)]
    if not cals:
        return Calibration()
    effs = [c.efficiency for c in cals]
    mpgs = [c.moves_per_game for c in cals if _num(c.moves_per_game)]
    scales = [c.outcome_scale for c in cals]
    sources: list = []
    fam_samples: dict = {}
    cost_samples: dict = {}
    for c in cals:
        sources.extend(c.sources)
        for fam, secs in (c.family_seconds or {}).items():
            if _num(secs):
                fam_samples.setdefault(fam, []).append(float(secs))
        for fam, flops in (c.cost_flops or {}).items():
            if _num(flops):
                cost_samples.setdefault(fam, []).append(float(flops))
    return Calibration(
        efficiency=sum(effs) / len(effs),
        moves_per_game=(sum(mpgs) / len(mpgs)) if mpgs else None,
        overhead_s=cals[0].overhead_s,
        outcome_scale=sum(scales) / len(scales),
        family_seconds={fam: sum(v) / len(v) for fam, v in fam_samples.items()},
        cost_flops={fam: sum(v) / len(v) for fam, v in cost_samples.items()},
        sources=sources,
    )


def cost_anchored_efficiency(cost_flops: dict, family_seconds: dict, peak_tflops) -> "float | None":
    """Achieved MFU implied by the cost records: the max over families of
    (FLOPs a dispatch / p50 dispatch seconds) / peak FLOP/s. None unless
    some family has both terms and the fraction lies in (0, 1]."""
    if not _num(peak_tflops) or peak_tflops <= 0:
        return None
    best = None
    for fam, flops in (cost_flops or {}).items():
        secs = (family_seconds or {}).get(fam)
        if _num(flops) and flops > 0 and _num(secs) and secs > 0:
            eff = (flops / secs) / (peak_tflops * 1e12)
            if 0 < eff <= 1 and (best is None or eff > best):
                best = eff
    return best


def calibration_from_targets(targets: list, root_dir: "str | None" = None) -> Calibration:
    """Calibration from earlier runs: each target through
    `load_comparable` (a run name, run directory, metrics.jsonl, or a
    perf or bench JSON), then the `tune_outcome` records, flight ring and
    cost records of its run. Unreadable targets are skipped with a log
    line; no history means the defaults."""
    from pathlib import Path

    from ..telemetry.flight import FLIGHT_FILENAME, family_seconds, read_flight
    from ..telemetry.ledger import read_ledger, resolve_ledger_path
    from ..telemetry.perf import load_comparable
    from ..telemetry.roofline import cost_flops_by_family

    cals = []
    for target in targets or []:
        summary, label = load_comparable(str(target), root_dir=root_dir)
        if summary is None:
            logger.info("tune: calibration target skipped (%s)", label)
            continue
        cal = calibration_from_summary(summary)
        if cal is None:
            logger.info("tune: %s has no usable mfu/throughput fields", label)
            continue
        source = summary.get("source")
        ratios = []
        ledger = resolve_ledger_path(Path(str(source))) if source else None
        if ledger is not None:
            for rec in read_ledger(ledger, kinds={"tune_outcome"}):
                ratio = rec.get("observed_over_predicted")
                if _num(ratio) and ratio > 0:
                    ratios.append(float(ratio))
            fams = family_seconds(read_flight(ledger.parent / FLIGHT_FILENAME))
            if fams:
                cal.family_seconds = fams
                cal.sources.append(f"flight x{len(fams)}")
            cost = cost_flops_by_family(read_ledger(ledger, kinds={"cost"}))
            if cost:
                cal.cost_flops = cost
                cal.sources.append(f"cost_flops x{len(cost)}")
                anchored = cost_anchored_efficiency(
                    cost, cal.family_seconds, summary.get("peak_bf16_tflops")
                )
                if anchored is not None:
                    cal.efficiency = anchored
                    cal.sources.append("efficiency<-cost_flops")
        if ratios:
            cal.outcome_scale = sum(ratios) / len(ratios)
            cal.sources.append(f"tune_outcome x{len(ratios)}")
        cals.append(cal)
    return merge_calibrations(cals)


def predict_throughput(
    candidate,
    env_config,
    model_config,
    mcts_config,
    lbatch: int,
    calibration: "Calibration | None" = None,
    peak_tflops: "float | None" = None,
    megastep: bool = False,
) -> dict:
    """Predicted steady-state throughput of one candidate: {games_per_hour,
    moves_per_sec, learner_steps_per_sec, flops_per_lane_move,
    dispatches_per_iteration, predicted_mfu, moves_per_game,
    peak_tflops}, the names the run's `UtilizationMeter` ledgers."""
    cal = calibration or Calibration()
    f = float(forward_flops(model_config, env_config, env_config.action_dim))
    sims = expected_simulations(mcts_config)
    step_f = float(train_step_flops(model_config, env_config, env_config.action_dim, lbatch))
    flops_per_lane_move = (sims + 1.0) * f + step_f / max(1, lbatch)

    peak = peak_tflops if peak_tflops else FALLBACK_PEAK_TFLOPS
    rate = cal.efficiency * peak * 1e12 * max(1, candidate.dp)
    b, t = candidate.sp_batch, candidate.chunk
    compute_s = b * t * flops_per_lane_move / max(rate, 1e-9)
    # Host dispatches an iteration: the megastep is one; a synchronous
    # iteration pays rollout + ingest + ceil(steps / K) learner groups.
    steps_per_iter = b * t / max(1, lbatch)
    dispatches = 1.0 if megastep else 2.0 + math.ceil(steps_per_iter / max(1, candidate.fused_k))
    iter_s = compute_s + dispatches * cal.overhead_s
    lane_moves_per_sec = b * t / iter_s if iter_s > 0 else 0.0
    moves_per_game = (
        cal.moves_per_game
        if _num(cal.moves_per_game) and cal.moves_per_game > 0
        else default_moves_per_game(env_config)
    )
    scale = max(1e-6, cal.outcome_scale)
    moves_per_sec = lane_moves_per_sec * scale
    achieved_flops = moves_per_sec * flops_per_lane_move
    return {
        "games_per_hour": moves_per_sec * 3600.0 / moves_per_game,
        "moves_per_sec": moves_per_sec,
        "learner_steps_per_sec": moves_per_sec / max(1, lbatch),
        "flops_per_lane_move": flops_per_lane_move,
        "dispatches_per_iteration": dispatches,
        "predicted_mfu": achieved_flops / (peak * 1e12 * max(1, candidate.dp)),
        "moves_per_game": moves_per_game,
        "peak_tflops": peak,
    }
