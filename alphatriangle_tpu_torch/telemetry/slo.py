"""Fleet SLO engine: counterpart of `alphatriangle_tpu/telemetry/slo.py`
(`collect_slos`, `evaluate_slos`, `write_fleet_prometheus`), computed
only from what the fleet already ledgers:

- **availability**: 1 - rejected / requests. Rejections are the router's
  `shed` and `exhausted` events in `fleet.jsonl`; the volume is the
  fleet parent's `kind: "util"` ticks (`serve_requests_per_sec *
  window_s`, each request once).
- **move latency**: the share of served requests that fell in a replica
  tick window whose `serve_move_latency_ms_p95` met the threshold, over
  every `replica_*/metrics.jsonl`.
- **dispatch success**: ok seals over all seals of `serve` family
  dispatches in the replicas' flight rings.

Each SLO is a good/total ratio against an objective, judged over
trailing windows by burn rate (`error_rate / (1 - objective)`) against
the fast and slow alert thresholds. "Now" is the newest record's time,
so a finished run is judged at its end. `fleet.prom` renders the
rejection codes as distinct counters and the burn rates as gauges.
Stdlib only.
"""

import logging
from dataclasses import dataclass
from pathlib import Path

from .flight import FLIGHT_FILENAME, read_flight
from .ledger import read_ledger

logger = logging.getLogger(__name__)

FLEET_PROM_FILENAME = "fleet.prom"

#: status -> the report's exit code (the JAX `cli slo` contract).
SLO_EXIT_CODES = {"ok": 0, "burning": 1, "no-data": 2}

#: (window_s, burn-rate threshold) pairs — the SRE-workbook fast-page /
#: slow-ticket alert pair, scaled to smoke-length runs by the caller
#: when needed.
DEFAULT_BURN_WINDOWS = ((300.0, 14.4), (3600.0, 6.0))

#: Default objectives: availability and dispatch success burn 1% error
#: budgets; the latency SLO targets 95% of requests under threshold.
DEFAULT_OBJECTIVES = {
    "availability": 0.99,
    "move-latency-p95": 0.95,
    "dispatch-success": 0.99,
}

DEFAULT_LATENCY_THRESHOLD_MS = 500.0


@dataclass(frozen=True)
class SLO:
    """One declarative objective over a good/total event stream."""

    name: str
    objective: float  # target good/total ratio in (0, 1)
    description: str
    #: (t, good, bad) samples, each counted once.
    samples: tuple

    def evaluate(self, now: float, windows) -> dict:
        budget = max(1e-9, 1.0 - self.objective)
        rows = []
        burning = False
        any_data = False
        for window_s, threshold in windows:
            good = bad = 0.0
            for t, g, b in self.samples:
                if t > now - window_s:
                    good += g
                    bad += b
            total = good + bad
            error_rate = (bad / total) if total > 0 else 0.0
            burn_rate = error_rate / budget
            window_burning = total > 0 and burn_rate >= threshold
            burning = burning or window_burning
            any_data = any_data or total > 0
            rows.append(
                {
                    "window_s": window_s,
                    "burn_threshold": threshold,
                    "total": round(total, 3),
                    "bad": round(bad, 3),
                    "error_rate": round(error_rate, 6),
                    "burn_rate": round(burn_rate, 3),
                    "burning": window_burning,
                }
            )
        status = (
            "burning" if burning else ("ok" if any_data else "no-data")
        )
        return {
            "name": self.name,
            "objective": self.objective,
            "error_budget": round(budget, 6),
            "description": self.description,
            "status": status,
            "windows": rows,
        }


def _times(samples) -> list:
    return [t for t, _g, _b in samples if isinstance(t, (int, float))]


def collect_slos(
    run_dir: "Path | str",
    *,
    latency_threshold_ms: float = DEFAULT_LATENCY_THRESHOLD_MS,
    objectives: "dict | None" = None,
) -> list[SLO]:
    """Build the fleet's SLO set from a fleet-parent run dir's ledgers
    (tolerant readers throughout — a legacy or partial run dir yields
    SLOs with empty sample streams, which evaluate to no-data)."""
    from ..serving.fleet import read_fleet_events

    run_dir = Path(run_dir)
    obj = {**DEFAULT_OBJECTIVES, **(objectives or {})}

    # availability: served volume from parent util ticks, rejections
    # from router events.
    avail: list = []
    for rec in read_ledger(run_dir / "metrics.jsonl", kinds={"util"}):
        rate = rec.get("serve_requests_per_sec")
        window = rec.get("window_s")
        t = rec.get("time")
        if (
            isinstance(rate, (int, float))
            and isinstance(window, (int, float))
            and isinstance(t, (int, float))
        ):
            avail.append((float(t), float(rate) * float(window), 0.0))
    for e in read_fleet_events(run_dir):
        if e.get("event") in ("shed", "exhausted") and isinstance(
            e.get("time"), (int, float)
        ):
            avail.append((float(e["time"]), 0.0, 1.0))

    latency: list = []
    dispatch: list = []
    for rdir in sorted(run_dir.glob("replica_*")):
        if not rdir.is_dir():
            continue
        for rec in read_ledger(rdir / "metrics.jsonl", kinds={"util"}):
            p95 = rec.get("serve_move_latency_ms_p95")
            t = rec.get("time")
            if not (
                isinstance(p95, (int, float))
                and isinstance(t, (int, float))
            ):
                continue
            n = rec.get("serve_window_requests")
            n = float(n) if isinstance(n, (int, float)) and n > 0 else 1.0
            if float(p95) <= latency_threshold_ms:
                latency.append((float(t), n, 0.0))
            else:
                latency.append((float(t), 0.0, n))
        for rec in read_flight(rdir / FLIGHT_FILENAME):
            if rec.get("phase") != "seal" or rec.get("family") != "serve":
                continue
            t = rec.get("time")
            if not isinstance(t, (int, float)):
                continue
            if rec.get("ok", True):
                dispatch.append((float(t), 1.0, 0.0))
            else:
                dispatch.append((float(t), 0.0, 1.0))

    return [
        SLO(
            name="availability",
            objective=obj["availability"],
            description="1 - (shed + retries-exhausted) / routed requests",
            samples=tuple(avail),
        ),
        SLO(
            name="move-latency-p95",
            objective=obj["move-latency-p95"],
            description=(
                "requests served in replica tick windows with "
                f"p95 move latency <= {latency_threshold_ms:g} ms"
            ),
            samples=tuple(latency),
        ),
        SLO(
            name="dispatch-success",
            objective=obj["dispatch-success"],
            description="ok serve/b<B> dispatch seals / all seals",
            samples=tuple(dispatch),
        ),
    ]


def evaluate_slos(
    run_dir: "Path | str",
    *,
    windows=DEFAULT_BURN_WINDOWS,
    now: "float | None" = None,
    latency_threshold_ms: float = DEFAULT_LATENCY_THRESHOLD_MS,
    objectives: "dict | None" = None,
) -> dict:
    """The SLO report: every SLO evaluated over every window,
    plus the roll-up status and exit code.

    `now` defaults to the newest sample time across all SLOs (a
    finished run's budget is judged at the moment it ended); pass an
    explicit epoch time to replay the alert state at a point in time.
    """
    run_dir = Path(run_dir)
    slos = collect_slos(
        run_dir,
        latency_threshold_ms=latency_threshold_ms,
        objectives=objectives,
    )
    newest = max(
        (t for slo in slos for t in _times(slo.samples)), default=None
    )
    eval_now = now if now is not None else newest
    results = [
        slo.evaluate(eval_now, windows) if eval_now is not None else {
            "name": slo.name,
            "objective": slo.objective,
            "error_budget": round(max(1e-9, 1.0 - slo.objective), 6),
            "description": slo.description,
            "status": "no-data",
            "windows": [],
        }
        for slo in slos
    ]
    if all(r["status"] == "no-data" for r in results):
        status = "no-data"
    elif any(r["status"] == "burning" for r in results):
        status = "burning"
    else:
        status = "ok"
    return {
        "schema": "alphatriangle.slo.v1",
        "run_dir": str(run_dir),
        "now": eval_now,
        "windows": [list(w) for w in windows],
        "slos": results,
        "status": status,
        "exit_code": SLO_EXIT_CODES[status],
    }


# --- aggregated whole-fleet Prometheus textfile --------------------------

#: counter name -> (summarize_fleet key, help text). Counters, not
#: gauges: these only ever grow over a run, and rejection codes stay
#: DISTINCT series so an alert can tell back-pressure (queue-full)
#: from an outage (no-healthy-replica) from replica sickness
#: (retries-exhausted).
_FLEET_COUNTERS = {
    "fleet_sheds_total": (
        "fleet_sheds",
        "Requests shed by the router (all rejection codes)",
    ),
    "fleet_shed_queue_full_total": (
        "fleet_shed_queue_full",
        "Requests shed with rejection=queue-full (admission bound)",
    ),
    "fleet_shed_no_healthy_replica_total": (
        "fleet_shed_no_healthy",
        "Requests shed with rejection=no-healthy-replica",
    ),
    "fleet_shed_retries_exhausted_total": (
        "fleet_shed_retries_exhausted",
        "Requests failed after exhausting every retry",
    ),
    "fleet_retries_total": ("fleet_retries", "Retry attempts dispatched"),
    "fleet_hedges_total": ("fleet_hedges", "Hedged dispatches launched"),
    "fleet_hedge_wins_total": (
        "fleet_hedge_wins",
        "Requests won by the hedge copy",
    ),
    "fleet_deaths_total": ("fleet_deaths", "Replica process deaths"),
    "fleet_respawns_total": ("fleet_respawns", "Replica respawns"),
    "fleet_evictions_total": (
        "fleet_evictions",
        "Replica evictions from routing admission",
    ),
}

_FLEET_GAUGES = {
    "fleet_requests_per_sec": (
        "fleet_requests_per_sec",
        "Completed routed requests per second (last storm)",
    ),
    "fleet_move_latency_ms_p95": (
        "fleet_move_latency_ms_p95",
        "Per-move latency p95 across the fleet (last storm), ms",
    ),
}


def write_fleet_prometheus(
    path: "Path | str",
    fleet_summary: "dict | None",
    slo_report: "dict | None" = None,
    run_name: str = "",
) -> bool:
    """Render the whole-fleet exposition: lifecycle/rejection counters
    from a `summarize_fleet` block + per-SLO burn-rate gauges from an
    `evaluate_slos` report. Atomic tmp+replace, mirror of
    `ledger.write_prometheus_textfile`."""
    path = Path(path)
    label = f'{{run="{run_name}"}}' if run_name else ""
    lines = []
    summary = fleet_summary or {}
    for name, (key, help_text) in _FLEET_COUNTERS.items():
        value = summary.get(key)
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        lines.append(f"# HELP alphatriangle_{name} {help_text}")
        lines.append(f"# TYPE alphatriangle_{name} counter")
        lines.append(f"alphatriangle_{name}{label} {value}")
    for name, (key, help_text) in _FLEET_GAUGES.items():
        value = summary.get(key)
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        lines.append(f"# HELP alphatriangle_{name} {help_text}")
        lines.append(f"# TYPE alphatriangle_{name} gauge")
        lines.append(f"alphatriangle_{name}{label} {value}")
    if slo_report:
        lines.append(
            "# HELP alphatriangle_slo_burn_rate SLO error-budget burn "
            "rate per trailing window"
        )
        lines.append("# TYPE alphatriangle_slo_burn_rate gauge")
        lines.append(
            "# HELP alphatriangle_slo_burning 1 when the SLO has a "
            "window past its burn threshold"
        )
        lines.append("# TYPE alphatriangle_slo_burning gauge")
        for slo in slo_report.get("slos", []):
            slo_name = slo.get("name")
            for w in slo.get("windows", []):
                wl = (
                    f'{{run="{run_name}",slo="{slo_name}",'
                    f'window_s="{w.get("window_s"):g}"}}'
                    if run_name
                    else f'{{slo="{slo_name}",'
                    f'window_s="{w.get("window_s"):g}"}}'
                )
                lines.append(
                    f"alphatriangle_slo_burn_rate{wl} "
                    f"{w.get('burn_rate', 0.0)}"
                )
            sl = (
                f'{{run="{run_name}",slo="{slo_name}"}}'
                if run_name
                else f'{{slo="{slo_name}"}}'
            )
            lines.append(
                f"alphatriangle_slo_burning{sl} "
                f"{1 if slo.get('status') == 'burning' else 0}"
            )
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text("\n".join(lines) + "\n")
        tmp.replace(path)
        return True
    except OSError:
        logger.exception("fleet prometheus write to %s failed", path)
        return False
