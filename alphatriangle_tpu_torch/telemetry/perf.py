"""Live utilization accounting and the run summaries: counterpart of
`alphatriangle_tpu/telemetry/perf.py`'s `UtilizationMeter`,
`_percentile`, `_mean`, `_trend`, `summarize_utilization`,
`summarize_league`, `summarize_fleet` and the cross-run comparison
(`load_comparable`, `compare_summaries`).

- `UtilizationMeter` folds a run's cumulative counters (served
  requests, simulations, dispatch wall) into one derived `kind: "util"`
  record per tick: moves/s, sims/s, achieved TFLOP/s from the analytic
  forward FLOPs (`utils/flops.py`), the card's memory, the chip's idle
  share of the tick window; the serve run's `serve_*` SLO fields ride
  in `extra`.
- `summarize_utilization` folds a run's util records into the `cli perf`
  summary (windowed step time, MFU, throughput and its trend);
  `summarize_league` a league run's `kind: "league"` records;
  `summarize_fleet` a fleet run's `kind: "fleet"` events into its
  lifecycle, routing and storm figures (`fleet.prom`, the report).
- `load_comparable` reads one side of `cli compare` (a `cli perf --json`
  snapshot, a bench JSON line, a ledger, a run directory or a run name)
  into a summary with the league and fleet folds; `compare_summaries`
  aligns two of them metric by metric against a threshold. Both carry
  the static memory budget of the run's `kind:"memory"` records
  (`fold_memory_budget`).

Stdlib only: `cli perf`, `cli compare`, `cli health` and the fleet
parent import this without torch.
"""

import json
import logging
import time
from pathlib import Path

from ..utils.flops import peak_bf16_tflops_info
from .memory import summarize_device_memory

logger = logging.getLogger(__name__)

SUMMARY_SCHEMA = "alphatriangle.perf.v1"

# Metrics `cli compare` aligns between two runs. Throughputs regress
# when they DROP; the memory metrics (peak bytes per device run-wide,
# composed static budget) regress when they GROW — a run that suddenly
# needs more device memory is a regression even when it is no slower. The serve metrics (serving/service.py) are the policy
# service's SLOs: per-move latency p95 regresses when it grows,
# served requests/s when it drops. Rows compare only when BOTH sides
# carry the metric, so training-vs-training comparisons never see the
# serve rows and vice versa.
COMPARE_METRICS = (
    "games_per_hour",
    "moves_per_sec",
    "learner_steps_per_sec",
    # Leaf-equivalent search effort per second: fresh simulations plus
    # root visits inherited through subtree reuse (ops/subtree_reuse.py);
    # with reuse off it equals sims/s exactly.
    "leaf_evals_per_sec",
    # Fraction of leaf-eval effort that was inherited rather than
    # re-searched (0 with reuse off). Informational next to the rate:
    # a run whose fraction collapses is re-searching work it used to
    # carry (e.g. reload churn clearing lanes).
    "mcts_reused_visit_fraction",
    "mfu",
    "mem_peak_bytes_in_use",
    "memory_budget_bytes",
    "serve_move_latency_ms_p95",
    "serve_requests_per_sec",
    # League flywheel (league/flywheel.py): how fast served games turn
    # into replay rows. Only flywheel runs carry it (rows compare only
    # when both sides have the metric, like the serve SLOs).
    "league_ingested_moves_per_sec",
    # Fleet storm SLOs (serving/fleet.py): end-to-end move latency and
    # served request rate as the ROUTER saw them — retries, hedges and
    # failovers included, so a fleet that hides replica churn well
    # compares well. Only fleet runs carry them.
    "fleet_move_latency_ms_p95",
    "fleet_requests_per_sec",
    # The fraction of each tick window with no dispatch in flight.
    # Lower is better: a run that got faster by starving the device less
    # shows up here even when throughput gains are marginal.
    "chip_idle_fraction",
)

# Metrics where a LOWER candidate value is the good direction.
LOWER_IS_BETTER = frozenset(
    {
        "mem_peak_bytes_in_use",
        "memory_budget_bytes",
        "serve_move_latency_ms_p95",
        "fleet_move_latency_ms_p95",
        "chip_idle_fraction",
    }
)



class UtilizationMeter:
    """Folds cumulative run counters into per-tick utilization records.

    Counters arrive cumulative (the loop's own `episodes_played`-style
    totals) so a missed tick never loses work — the next tick's delta
    absorbs it. The first tick establishes the baseline and yields no
    record.
    """

    def __init__(
        self,
        forward_flops: int = 0,
        train_step_flops: int = 0,
        device_kind: str = "",
        buffer_capacity: int = 0,
        mesh_devices: int = 1,
        clock=time.monotonic,
    ) -> None:
        self.forward_flops = int(forward_flops)
        self.train_step_flops = int(train_step_flops)
        self.device_kind = device_kind
        self.buffer_capacity = int(buffer_capacity)
        # Width of the mesh the dispatch counters run over. The gauge
        # contract is MESH-LEVEL: one dispatch = one host-side program
        # launch, regardless of how many devices execute it (a dp=8
        # megastep iteration is still 1 dispatch, not 8) — so this is
        # recorded beside the gauge, never multiplied into it.
        self.mesh_devices = max(1, int(mesh_devices))
        peak, source = peak_bf16_tflops_info(device_kind)
        self.peak_tflops = peak
        self.peak_source = source
        self._clock = clock
        self._prev: "dict | None" = None
        # Run-wide high-water of observed bytes_in_use: the backstop
        # peak where a device reports no peak_bytes_in_use.
        self._mem_high_water = 0

    def device_info(self) -> dict:
        """Static device facts for `health.json` / summaries."""
        return {
            "device_kind": self.device_kind,
            "peak_bf16_tflops": self.peak_tflops,
            "peak_source": self.peak_source,
            "mesh_devices": self.mesh_devices,
        }

    def tick(
        self,
        step: int,
        episodes: int = 0,
        experiences: int = 0,
        simulations: int = 0,
        reused_visits: int = 0,
        buffer_size: int = 0,
        transfer_h2d_s: float = 0.0,
        transfer_d2h_s: float = 0.0,
        compile_hits: int = 0,
        compile_misses: int = 0,
        device_memory: "list | None" = None,
        dispatches: int = 0,
        iterations: int = 0,
        dispatch_wall_s: "float | None" = None,
        extra: "dict | None" = None,
    ) -> "dict | None":
        """One derived utilization record, or None (first/zero-width tick).

        `extra`: caller-owned fields merged verbatim into the record —
        the policy service rides its per-window `serve_*` SLO fields
        (queue wait / move latency percentiles, occupancy) into the
        ledger this way (serving/service.py).

        `dispatch_wall_s`: cumulative sealed dispatch wall from the
        run's flight recorder (`FlightRecorder.sealed_wall_seconds`).
        When supplied on consecutive ticks, the record carries
        `chip_idle_fraction` — the fraction of the tick window with no
        dispatch in flight. The name is the JAX package's; on the port it
        is not the card's idle share. A bracket opens before the host
        launches a search and seals after its one synchronising fetch, so
        the launches count as busy: a launch-bound serve dispatch leaves
        the card idle most of its wall and still reads near 0 under load.
        Records of callers that never pass it carry no such field.

        `compile_hits` / `compile_misses` are the kernel build cache's
        counts (`compile_cache.BuildCache.stats`): libraries loaded from
        the build directory and libraries `nvcc` built in this process."""
        now = self._clock()
        # Memory accounting folds on EVERY tick (including the baseline
        # tick that yields no rate record) so the high-water mark never
        # misses a sample.
        mem = self._fold_memory(device_memory)
        cur = {
            "step": step,
            "episodes": episodes,
            "experiences": experiences,
            "simulations": simulations,
            "reused_visits": reused_visits,
            "transfer_h2d_s": transfer_h2d_s,
            "transfer_d2h_s": transfer_d2h_s,
            "dispatches": dispatches,
            "iterations": iterations,
        }
        if isinstance(dispatch_wall_s, (int, float)):
            cur["dispatch_wall_s"] = float(dispatch_wall_s)
        prev, self._prev = self._prev, {"t": now, **cur}
        if prev is None:
            return None
        dt = now - prev["t"]
        if dt <= 0:
            return None
        # The dispatch-wall counter may appear mid-run (flight recorder
        # attached late); a delta only exists once BOTH ticks carry it.
        d = {
            k: cur[k] - prev[k] for k in cur if k in prev
        }
        chip_idle = None
        if "dispatch_wall_s" in d:
            busy = max(0.0, d["dispatch_wall_s"])
            chip_idle = max(0.0, min(1.0, 1.0 - busy / dt))
        steps_s = max(0.0, d["step"]) / dt
        moves_s = max(0.0, d["experiences"]) / dt
        sims_s = max(0.0, d["simulations"]) / dt
        # Leaf-equivalent effort: fresh simulations plus visits carried
        # across moves by subtree reuse (MCTSConfig.tree_reuse). With
        # reuse off the delta is 0 and leaf-evals/s == sims/s exactly.
        reused_s = max(0.0, d["reused_visits"]) / dt
        leaf_s = sims_s + reused_s
        # Achieved model FLOP/s: learner steps x analytic step FLOPs +
        # self-play net evals (one per simulation leaf + ~one root eval
        # per move; experiences/s approximates moves x lanes).
        learner_fs = steps_s * self.train_step_flops
        sp_fs = (sims_s + moves_s) * self.forward_flops
        tflops = (learner_fs + sp_fs) / 1e12
        mfu = (
            tflops / self.peak_tflops
            if self.peak_tflops and tflops > 0
            else None
        )
        total_compiles = compile_hits + compile_misses
        record = {
            **(mem or {}),
            "kind": "util",
            "step": step,
            "time": time.time(),
            "window_s": round(dt, 3),
            "learner_steps_per_sec": round(steps_s, 4),
            "step_time_ms": (
                round(1000.0 / steps_s, 3) if steps_s > 0 else None
            ),
            "moves_per_sec": round(moves_s, 2),
            "games_per_hour": round(
                max(0.0, d["episodes"]) * 3600.0 / dt, 2
            ),
            "sims_per_sec": round(sims_s, 1),
            "leaf_evals_per_sec": round(leaf_s, 1),
            "mcts_reused_visit_fraction": (
                round(reused_s / leaf_s, 4) if leaf_s > 0 else None
            ),
            # 6+8 decimals: a test-sized net on CPU runs ~1e-6 TFLOP/s
            # and must not round its MFU down to an ambiguous 0.0.
            "tflops_per_sec": round(tflops, 6),
            "mfu": round(mfu, 8) if mfu is not None else None,
            "device_kind": self.device_kind,
            "peak_bf16_tflops": self.peak_tflops,
            "peak_source": self.peak_source,
            "buffer_size": buffer_size,
            "buffer_fill": (
                round(buffer_size / self.buffer_capacity, 4)
                if self.buffer_capacity
                else None
            ),
            "transfer_h2d_ms": round(
                max(0.0, d["transfer_h2d_s"]) * 1000.0, 2
            ),
            "transfer_d2h_ms": round(
                max(0.0, d["transfer_d2h_s"]) * 1000.0, 2
            ),
            "compile_cache_hits": compile_hits,
            "compile_cache_misses": compile_misses,
            "compile_cache_hit_rate": (
                round(compile_hits / total_compiles, 4)
                if total_compiles
                else None
            ),
            # Mesh-level program dispatches per loop iteration: the
            # host-round-trip gauge the fused megastep exists to
            # collapse to 1.0 (sync runs ~3: rollout + ingest + learner
            # group). Counters tick once per host launch, NOT once per
            # device execution — a dp-sharded megastep iteration is one
            # dispatch whether the mesh has 1 device or 8; mesh_devices
            # carries the width for readers that want per-device
            # executions (gauge x mesh_devices).
            "dispatches_per_iteration": (
                round(
                    max(0, d["dispatches"]) / d["iterations"], 3
                )
                if d["iterations"] > 0
                else None
            ),
            "mesh_devices": self.mesh_devices,
        }
        if chip_idle is not None:
            # The window's sealed-dispatch wall over the window, only
            # when the counter was supplied.
            record["chip_idle_fraction"] = round(chip_idle, 6)
        if extra:
            record.update(extra)
        return record

    def _fold_memory(self, device_memory: "list | None") -> "dict | None":
        """Device-memory totals for one tick + the run-wide high-water
        update. None when the backend reports
        nothing (the record then simply carries no mem_* fields)."""
        totals = summarize_device_memory(device_memory)
        if totals is None:
            return None
        in_use = totals["bytes_in_use"]
        self._mem_high_water = max(self._mem_high_water, in_use)
        peak = max(self._mem_high_water, totals["peak_bytes_in_use"])
        limit = totals["bytes_limit"]
        out = {
            "mem_bytes_in_use": in_use,
            "mem_peak_bytes_in_use": peak,
            "mem_bytes_limit": limit,
            "mem_utilization": (
                round(in_use / limit, 6) if limit else None
            ),
            "mem_devices": [
                {
                    k: d.get(k)
                    for k in (
                        "device",
                        "kind",
                        "bytes_in_use",
                        "peak_bytes_in_use",
                        "bytes_limit",
                    )
                }
                for d in device_memory
                if isinstance(d, dict)
            ],
        }
        return out


def _percentile(values: list, q: float) -> "float | None":
    """Nearest-rank percentile; None for an empty list (no numpy: this
    runs in the fleet parent)."""
    vals = sorted(v for v in values if isinstance(v, (int, float)))
    if not vals:
        return None
    idx = min(len(vals) - 1, max(0, round(q * (len(vals) - 1))))
    return float(vals[idx])


def _mean(values: list) -> "float | None":
    vals = [v for v in values if isinstance(v, (int, float))]
    return sum(vals) / len(vals) if vals else None


def _trend(values: list) -> "float | None":
    """Second-half mean over first-half mean, minus 1 (signed drift)."""
    vals = [v for v in values if isinstance(v, (int, float))]
    if len(vals) < 4:
        return None
    half = len(vals) // 2
    first, second = _mean(vals[:half]), _mean(vals[half:])
    if not first:
        return None
    return second / first - 1.0


def summarize_utilization(
    records: list, window: "int | None" = None
) -> "dict | None":
    """Fold a run's util records into the `cli perf` summary.

    `window` keeps only the newest N records (the whole run otherwise).
    None when no usable records exist (schema failure for callers).

    Tolerates historical ledgers: runs recorded before the `kind`
    field (or before the serve/mem/dispatch gauges) still summarize —
    a kind-less record counts as a util tick when it carries any core
    throughput field; fields added later simply come out None.
    """
    _UTIL_SIGNATURE = (
        "moves_per_sec",
        "learner_steps_per_sec",
        "games_per_hour",
        "step_time_ms",
        "mfu",
    )
    records = [
        r
        for r in records
        if isinstance(r, dict)
        and (
            r.get("kind") == "util"
            or (
                "kind" not in r
                and any(k in r for k in _UTIL_SIGNATURE)
            )
        )
    ]
    if not records:
        return None
    full_span = len(records)
    if window is not None and window > 0:
        records = records[-window:]

    def col(key: str) -> list:
        return [r.get(key) for r in records]

    last = records[-1]
    mfus = [v for v in col("mfu") if isinstance(v, (int, float))]

    def numeric(key: str) -> list:
        return [v for v in col(key) if isinstance(v, (int, float))]

    # Serve SLO summary (records written by serving/service.py ticks):
    # p50 averages across tick windows, p95 takes the WORST window —
    # the conservative bound an SLO gate wants.
    serve: dict = {}
    if numeric("serve_move_latency_ms_p95"):
        serve = {
            "serve_move_latency_ms_p50": _mean(
                numeric("serve_move_latency_ms_p50")
            ),
            "serve_move_latency_ms_p95": max(
                numeric("serve_move_latency_ms_p95")
            ),
            "serve_queue_wait_ms_p50": _mean(
                numeric("serve_queue_wait_ms_p50")
            ),
            "serve_queue_wait_ms_p95": (
                max(numeric("serve_queue_wait_ms_p95"))
                if numeric("serve_queue_wait_ms_p95")
                else None
            ),
            "serve_requests_per_sec": _mean(
                numeric("serve_requests_per_sec")
            ),
            "serve_requests_total": last.get("serve_requests_total"),
            "serve_sessions_last": last.get("serve_sessions"),
            "serve_sessions_admitted": last.get("serve_sessions_admitted"),
            "serve_sessions_retired": last.get("serve_sessions_retired"),
            "serve_slots": last.get("serve_slots"),
            "serve_batch_fill": _mean(numeric("serve_batch_fill")),
            "serve_weight_reloads": last.get("serve_weight_reloads"),
            # Bucket-ladder micro-batcher (serving/buckets.py): the
            # rung the service ended on, the windowed wave fill that
            # drives rung walking, and how many switches the run made.
            "serve_bucket": last.get("serve_bucket"),
            "serve_fill": _mean(numeric("serve_fill")),
            "serve_rung_switches": last.get("serve_rung_switches"),
        }
    # Device-stats gauges, which the JAX package's stat-packs mirror onto
    # its util records. The port writes none yet; a ledger without them
    # gets no such keys.
    devstats: dict = {}
    if numeric("root_visit_entropy") or numeric("tree_occupancy"):
        occ = numeric("tree_occupancy")
        devstats = {
            "root_visit_entropy": _mean(numeric("root_visit_entropy")),
            "tree_occupancy": _mean(occ),
            "tree_occupancy_max": max(occ) if occ else None,
            "beacons_armed": last.get("beacons_armed"),
        }
    # The idle gauge: the share of each tick with no dispatch in flight
    # (`UtilizationMeter.tick`'s `chip_idle_fraction`), only on records
    # whose writer passed the sealed dispatch wall.
    roofline: dict = {}
    idle = numeric("chip_idle_fraction")
    if idle:
        roofline = {
            "chip_idle_fraction": _mean(idle),
            "chip_idle_fraction_max": max(idle),
        }
    return {
        **serve,
        **devstats,
        **roofline,
        "schema": SUMMARY_SCHEMA,
        "ticks": len(records),
        "ticks_total": full_span,
        "first_step": records[0].get("step"),
        "last_step": last.get("step"),
        "wall_seconds": round(
            sum(
                r.get("window_s", 0.0)
                for r in records
                if isinstance(r.get("window_s"), (int, float))
            ),
            1,
        ),
        "device_kind": last.get("device_kind"),
        "peak_bf16_tflops": last.get("peak_bf16_tflops"),
        "peak_source": last.get("peak_source"),
        "step_time_ms_p50": _percentile(col("step_time_ms"), 0.50),
        "step_time_ms_p95": _percentile(col("step_time_ms"), 0.95),
        "learner_steps_per_sec": _mean(col("learner_steps_per_sec")),
        "moves_per_sec": _mean(col("moves_per_sec")),
        "games_per_hour": _mean(col("games_per_hour")),
        "sims_per_sec": _mean(col("sims_per_sec")),
        "leaf_evals_per_sec": _mean(col("leaf_evals_per_sec")),
        "mcts_reused_visit_fraction": _mean(
            col("mcts_reused_visit_fraction")
        ),
        "tflops_per_sec": _mean(col("tflops_per_sec")),
        "mfu": _mean(mfus),
        "mfu_max": max(mfus) if mfus else None,
        "buffer_fill_last": last.get("buffer_fill"),
        "transfer_h2d_ms": _mean(col("transfer_h2d_ms")),
        "transfer_d2h_ms": _mean(col("transfer_d2h_ms")),
        "compile_cache_hit_rate": last.get("compile_cache_hit_rate"),
        "dispatches_per_iteration": _mean(col("dispatches_per_iteration")),
        # Memory: run-wide observed peak, plus the newest in-use/limit
        # snapshot for the `cli perf` readout.
        "mem_peak_bytes_in_use": (
            max(
                (
                    v
                    for v in col("mem_peak_bytes_in_use")
                    if isinstance(v, (int, float))
                ),
                default=None,
            )
        ),
        "mem_bytes_in_use_last": last.get("mem_bytes_in_use"),
        "mem_bytes_limit": last.get("mem_bytes_limit"),
        "throughput_trend": _trend(
            col("moves_per_sec")
            if any(isinstance(v, (int, float)) and v > 0 for v in col("moves_per_sec"))
            else col("learner_steps_per_sec")
        ),
    }


def summarize_league(records: list) -> "dict | None":
    """Fold a run's `kind:"league"` records (league/flywheel.py, one
    per matchmade round) into the league block of the `cli perf`
    summary: pool size, ingest volume/rate, opponent-mix histogram,
    mean trajectory staleness, promotions. None for non-flywheel runs
    (no league records), so the block and the compare row only appear
    where the flywheel ran."""
    league = [
        r for r in records if isinstance(r, dict) and r.get("kind") == "league"
    ]
    if not league:
        return None
    last = league[-1]

    def numeric(key: str) -> list:
        return [
            r.get(key)
            for r in league
            if isinstance(r.get(key), (int, float))
            and not isinstance(r.get(key), bool)
        ]

    moves = numeric("moves_ingested")
    return {
        "league_rounds": len(league),
        "league_pool_size": last.get("pool_size"),
        "league_moves_ingested": int(sum(moves)) if moves else None,
        "league_ingested_moves_per_sec": _mean(
            numeric("ingested_moves_per_sec")
        ),
        "league_mean_staleness": _mean(numeric("mean_staleness")),
        "league_stale_dropped": last.get("stale_dropped_total"),
        "league_promotions": last.get("promotions"),
        "league_live_elo": last.get("live_elo"),
        "league_opponent_mix": last.get("opponent_mix"),
    }


def summarize_fleet(records: list) -> "dict | None":
    """Fold a fleet run's `kind:"fleet"` events (serving/fleet.py,
    fleet.jsonl) into the fleet block of the `cli perf` summary:
    lifecycle counts (deaths -> respawns -> readmissions), routing
    decisions (sheds / retries / hedge wins), rolling-reload recompile
    total, and the last storm's throughput + latency SLOs. None when
    the run never ran a fleet (no fleet events), so the block and the
    compare rows only appear where the fleet ran."""
    events = [
        r for r in records if isinstance(r, dict) and r.get("kind") == "fleet"
    ]
    if not events:
        return None

    def count(*names: str) -> int:
        return sum(1 for r in events if r.get("event") in names)

    out = {
        "fleet_events": len(events),
        "fleet_deaths": count("death"),
        "fleet_respawns": count("respawn"),
        "fleet_evictions": count("evict"),
        "fleet_readmissions": count("readmit"),
        "fleet_sheds": count("shed"),
        # Rejection codes kept distinct (serving/router.py REJECT_*):
        # queue-full is admission back-pressure, no-healthy-replica is
        # a fleet outage, retries-exhausted is a replica sickness —
        # one folded shed total hides which one is burning the budget.
        "fleet_shed_queue_full": sum(
            1
            for r in events
            if r.get("event") == "shed"
            and r.get("rejection") == "queue-full"
        ),
        "fleet_shed_no_healthy": sum(
            1
            for r in events
            if r.get("event") == "shed"
            and r.get("rejection") == "no-healthy-replica"
        ),
        "fleet_shed_retries_exhausted": count("exhausted"),
        "fleet_retries": count("retry"),
        "fleet_hedges": count("hedge"),
        "fleet_hedge_wins": count("hedge-win"),
        "fleet_reload_recompiles": sum(
            r.get("recompiles", 0)
            for r in events
            if r.get("event") == "replica-reloaded"
            and isinstance(r.get("recompiles"), int)
        ),
    }
    stop = [r for r in events if r.get("event") == "fleet-stop"]
    if stop:
        out["fleet_gaveup"] = stop[-1].get("gaveup")
    storms = [r for r in events if r.get("event") == "storm-summary"]
    if storms:
        storm = storms[-1]
        out.update(
            {
                "fleet_requests": storm.get("requests"),
                "fleet_completed": storm.get("completed"),
                "fleet_shed_requests": storm.get("shed"),
                "fleet_lost": storm.get("lost"),
                "fleet_requests_per_sec": storm.get("requests_per_sec"),
                "fleet_move_latency_ms_p50": storm.get(
                    "move_latency_ms_p50"
                ),
                "fleet_move_latency_ms_p95": storm.get(
                    "move_latency_ms_p95"
                ),
            }
        )
    return out


# --- cross-run comparison ----------------------------------------------


def _summary_from_bench(payload: dict, label: str) -> "dict | None":
    """Normalize one `bench.py` JSON line into compare metrics."""
    if payload.get("metric") != "self_play_games_per_hour":
        return None
    extra = payload.get("extra") or {}
    flops = extra.get("flops") or {}
    return {
        "schema": SUMMARY_SCHEMA,
        "source": label,
        "games_per_hour": payload.get("value"),
        "moves_per_sec": extra.get("moves_per_sec"),
        "leaf_evals_per_sec": extra.get("leaf_evals_per_sec"),
        "mcts_reused_visit_fraction": extra.get(
            "mcts_reused_visit_fraction"
        ),
        "learner_steps_per_sec": (
            extra.get("learner_steps_per_sec_fused")
            or extra.get("learner_steps_per_sec")
        ),
        "mfu": flops.get("self_play_mfu"),
        "device_kind": extra.get("device_kind"),
    }


def load_comparable(
    target: str, root_dir: "str | None" = None
) -> "tuple[dict | None, str]":
    """(normalized summary, label) for one side of `cli compare`.

    Accepts, in resolution order: a perf-summary JSON file (from
    `cli perf --json`), a bench JSON line file (`BENCH_*.json`), a
    `metrics.jsonl` path, a run directory, or a run name under the
    runs root. Returns (None, reason) when nothing usable exists.
    """
    from .ledger import read_ledger, resolve_ledger_path

    path = Path(target)
    if path.is_file() and path.suffix == ".json":
        try:
            payload = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError) as exc:
            return None, f"{target}: unreadable JSON ({exc})"
        if isinstance(payload, dict):
            if payload.get("schema") == SUMMARY_SCHEMA:
                payload.setdefault("source", str(path))
                return payload, str(path)
            bench = _summary_from_bench(payload, str(path))
            if bench is not None:
                return bench, str(path)
        return None, f"{target}: not a perf summary or bench JSON"
    if path.exists():
        ledger = resolve_ledger_path(path)
    else:
        run_dir = _run_dir_for(target, root_dir)
        ledger = resolve_ledger_path(run_dir) if run_dir else None
    if ledger is None:
        return None, f"{target}: no metrics ledger found"
    # Read ALL records (no kinds= pre-filter): ledgers written before
    # the `kind` field exist, and the pre-filter would drop their
    # util ticks before the tolerant summarize above ever saw them.
    records = read_ledger(ledger)
    summary = summarize_utilization(records)
    if summary is None:
        return None, f"{ledger}: no utilization records"
    fold_memory_budget(summary, records)
    fold_league_and_fleet(summary, records, ledger)
    summary["source"] = str(ledger)
    return summary, str(ledger)


def fold_memory_budget(summary: dict, records: list) -> "int | None":
    """Fold the static memory budget of the run's `kind:"memory"`
    records (`memory.compose_budget`) into `summary` as
    `memory_budget_bytes` (in place), so `cli compare` gates its growth
    beside the observed peak. Returns it; None without records or when
    it is 0."""
    from .memory import compose_budget

    mem_records = [r for r in records if r.get("kind") == "memory"]
    if not mem_records:
        return None
    total = compose_budget(mem_records)["total_bytes"]
    if total <= 0:
        return None
    summary["memory_budget_bytes"] = total
    return total


def fold_league_and_fleet(
    summary: dict, records: list, ledger: "Path | str"
) -> "tuple[dict | None, dict | None]":
    """Fold into `summary` (in place) the league flywheel's league_*
    fields from the ledger's `kind:"league"` records, and a fleet
    parent's fleet_* fields from the `fleet.jsonl` (serving/fleet.py's
    decision ledger) BESIDE the metrics ledger: with them come the
    league and fleet SLO rows of `cli compare` and the lines of `cli
    perf`. Returns the two folds, each None when absent."""
    from .ledger import read_ledger

    league = summarize_league([r for r in records if r.get("kind") == "league"])
    if league is not None:
        summary.update(league)
    fleet_path = Path(ledger).parent / "fleet.jsonl"
    fleet = summarize_fleet(read_ledger(fleet_path)) if fleet_path.is_file() else None
    if fleet is not None:
        summary.update(fleet)
    return league, fleet


def _run_dir_for(run_name: str, root_dir: "str | None") -> "Path | None":
    from ..config.persistence_config import PersistenceConfig

    persistence = PersistenceConfig(RUN_NAME=run_name)
    if root_dir:
        persistence = persistence.model_copy(
            update={"ROOT_DATA_DIR": root_dir}
        )
    run_dir = persistence.get_run_base_dir()
    return run_dir if run_dir.is_dir() else None


def compare_summaries(
    a: dict, b: dict, threshold: float = 0.1, metrics=None
) -> tuple[list, list]:
    """(rows, regressions) comparing candidate `a` against baseline `b`.

    A row is (metric, a_value, b_value, ratio, status). For throughput
    metrics, status is "regression" when a < b * (1 - threshold) and
    "improved" when a > b * (1 + threshold); for LOWER_IS_BETTER
    metrics (peak bytes, memory budget, serve latency p95) the
    directions flip — growth past the threshold is the regression.
    "n/a" when either side is missing. `regressions` lists the
    regressed metric names. `metrics` restricts the compared set (the
    `cli compare --metrics` selector; serve-smoke gates the serve SLO
    rows alone with it); default is all of COMPARE_METRICS.
    """
    rows = []
    regressions = []
    for metric in metrics if metrics is not None else COMPARE_METRICS:
        va, vb = a.get(metric), b.get(metric)
        usable = all(
            isinstance(v, (int, float)) and not isinstance(v, bool)
            for v in (va, vb)
        )
        if not usable or vb <= 0:
            rows.append((metric, va, vb, None, "n/a"))
            continue
        ratio = va / vb
        if metric in LOWER_IS_BETTER:
            better, worse = ratio < 1.0 - threshold, ratio > 1.0 + threshold
        else:
            better, worse = ratio > 1.0 + threshold, ratio < 1.0 - threshold
        if worse:
            status = "regression"
            regressions.append(metric)
        elif better:
            status = "improved"
        else:
            status = "ok"
        rows.append((metric, va, vb, ratio, status))
    return rows, regressions
