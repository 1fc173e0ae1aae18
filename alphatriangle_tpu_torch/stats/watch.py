"""The live-run console's readers: counterpart of
`alphatriangle_tpu/stats/watch.py`.

`cli watch` tails a run's files from any shell and renders its vitals:
`live_metrics.jsonl` (the `StatsCollector`'s ticks: games/h and learner
steps/s over a window, losses, the replay ratio, the pipeline),
`metrics.jsonl` (the newest `kind:"util"` record: MFU, step time,
transfers, memory, the stat-pack gauges, the idle share),
`flight.jsonl` (the dispatch in flight, or the last sealed one),
`health.json` (live or STALLED) and, in a fleet parent's run directory,
`fleet.jsonl` (routable replicas, sheds, retries, hedges, deaths, the
last router decision). Pure functions and small folding states, so a
frame renders without a live run. Stdlib only: the console runs beside
a training process, or a wedged card, without torch.
"""

import json
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

# Window over which rates (games/h, steps/s) are computed: long enough
# to smooth chunked arrivals, short enough to track a run going sick.
RATE_WINDOW_S = 120.0

# Shed-rate window for the fleet line: short — back-pressure is a
# now-problem, and the rate should fall back to zero quickly once the
# brownout passes.
FLEET_RATE_WINDOW_S = 60.0


@dataclass
class WatchState:
    """Folds live-metric ticks; exposes latest values + windowed rates."""

    latest: dict = field(default_factory=dict)
    latest_step: int = 0
    latest_time: float = 0.0
    # Newest utilization record from the metrics ledger
    # (telemetry/perf.py): MFU, step time, transfer costs.
    util: dict = field(default_factory=dict)
    # Newest flight-ring records (telemetry/flight.py): the last intent
    # written and the last seal — together they say what the device is
    # doing RIGHT NOW (or what it finished last).
    flight_intent: dict = field(default_factory=dict)
    flight_seal: dict = field(default_factory=dict)
    # (wall time, step, cumulative episodes) samples for rate windows.
    _samples: deque = field(default_factory=lambda: deque(maxlen=512))

    def fold_line(self, line: str) -> bool:
        """Fold one JSONL line; returns False for junk (torn writes)."""
        line = line.strip()
        if not line:
            return False
        try:
            tick = json.loads(line)
            step = int(tick["step"])
            wall = float(tick["time"])
            means = tick["means"]
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            return False
        self.latest.update(means)
        self.latest_step = step
        self.latest_time = wall
        self._samples.append(
            (wall, step, means.get("Progress/Episodes_Played"))
        )
        return True

    def fold_util_line(self, line: str) -> bool:
        """Fold one metrics-ledger line; only `kind: util` records are
        kept (tick records duplicate live_metrics.jsonl). Returns False
        for junk/torn/non-util lines."""
        line = line.strip()
        if not line:
            return False
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            return False
        if not isinstance(rec, dict) or rec.get("kind") != "util":
            return False
        self.util = rec
        return True

    def fold_flight_line(self, line: str) -> bool:
        """Fold one flight-ring line (telemetry/flight.py schema);
        keeps the newest intent and the newest seal. Returns False for
        junk/torn/non-flight lines."""
        line = line.strip()
        if not line:
            return False
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            return False
        if not isinstance(rec, dict) or rec.get("kind") != "flight":
            return False
        phase = rec.get("phase")
        if phase == "intent":
            self.flight_intent = rec
        elif phase == "seal":
            self.flight_seal = rec
        else:
            return False
        return True

    def _window(self) -> "tuple | None":
        """(oldest, newest) samples spanning <= RATE_WINDOW_S, or None."""
        if len(self._samples) < 2:
            return None
        newest = self._samples[-1]
        oldest = None
        for s in self._samples:
            if newest[0] - s[0] <= RATE_WINDOW_S:
                oldest = s
                break
        if oldest is None or newest[0] <= oldest[0]:
            return None
        return oldest, newest

    @property
    def steps_per_sec(self) -> "float | None":
        w = self._window()
        if w is None:
            return None
        (t0, s0, _), (t1, s1, _) = w
        return (s1 - s0) / (t1 - t0)

    @property
    def games_per_hour(self) -> "float | None":
        # The collector flushes only metrics logged since the last
        # tick, so learner-only ticks carry no episode count; take the
        # oldest/newest samples IN the window that have one, not the
        # literal endpoints — otherwise the headline rate flaps to "—"
        # whenever a learner-dominated tick lands last.
        if len(self._samples) < 2:
            return None
        newest_t = self._samples[-1][0]
        with_eps = [
            s
            for s in self._samples
            if s[2] is not None and newest_t - s[0] <= RATE_WINDOW_S
        ]
        if len(with_eps) < 2:
            return None
        (t0, _, e0), (t1, _, e1) = with_eps[0], with_eps[-1]
        if t1 <= t0:
            return None
        return (e1 - e0) * 3600.0 / (t1 - t0)

    @property
    def age_seconds(self) -> "float | None":
        """Seconds since the last tick (stall indicator)."""
        if not self.latest_time:
            return None
        return max(0.0, time.time() - self.latest_time)


def _fmt(value: "float | None", spec: str = ",.1f", unit: str = "") -> str:
    if value is None:
        return "—"
    return f"{value:{spec}}{unit}"


#: fleet.jsonl lifecycle events -> the replica status they imply.
_FLEET_STATUS = {
    "spawn": "starting",
    "respawn": "starting",
    "replica-ready": "up",
    "readmit": "up",
    "evict": "evicted",
    "death": "down",
    "give-up": "gone",
}

#: Router decision events worth echoing as "last decision".
_ROUTER_EVENTS = {"shed", "retry", "exhausted", "hedge", "hedge-win"}


@dataclass
class FleetWatchState:
    """Folds `fleet.jsonl` events (serving/fleet.py `_event` schema:
    lifecycle spawns/deaths/evictions interleaved with router
    shed/retry/hedge decisions) into the `cli watch` fleet line."""

    #: replica name -> last lifecycle status (see _FLEET_STATUS).
    replicas: dict = field(default_factory=dict)
    #: replica name -> current serve rung (slot count). Spawn/ready/
    #: readmit events carry `slots`, so a quarantine-halved or
    #: ladder-walked replica shows its real shape here.
    rungs: dict = field(default_factory=dict)
    #: replica name -> inference precision ("int8"/"bfloat16"/...).
    precisions: dict = field(default_factory=dict)
    #: newest router admission level (requests in flight at the router).
    inflight: "int | None" = None
    sheds: int = 0
    retries: int = 0
    exhausted: int = 0
    hedges: int = 0
    hedge_wins: int = 0
    deaths: int = 0
    #: newest router decision record, verbatim.
    last_decision: dict = field(default_factory=dict)
    latest_time: float = 0.0
    _shed_times: deque = field(default_factory=lambda: deque(maxlen=2048))

    def fold_fleet_line(self, line: str) -> bool:
        """Fold one fleet.jsonl line; False for junk/torn/non-fleet
        lines (same contract as the other folders — tolerant of
        legacy records without trace ids)."""
        line = line.strip()
        if not line:
            return False
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            return False
        if not isinstance(rec, dict) or rec.get("kind") != "fleet":
            return False
        event = rec.get("event")
        t = rec.get("time")
        if isinstance(t, (int, float)):
            self.latest_time = max(self.latest_time, float(t))
        name = rec.get("replica")
        status = _FLEET_STATUS.get(event)
        if status is not None and name:
            self.replicas[str(name)] = status
            # Legacy records carry neither field; fold only what's there.
            if isinstance(rec.get("slots"), int):
                self.rungs[str(name)] = rec["slots"]
            if isinstance(rec.get("precision"), str):
                self.precisions[str(name)] = rec["precision"]
        if isinstance(rec.get("inflight"), int):
            self.inflight = rec["inflight"]
        if event == "shed":
            self.sheds += 1
            if isinstance(t, (int, float)):
                self._shed_times.append(float(t))
        elif event == "retry":
            self.retries += 1
        elif event == "exhausted":
            self.exhausted += 1
        elif event == "hedge":
            self.hedges += 1
        elif event == "hedge-win":
            self.hedge_wins += 1
        elif event == "death":
            self.deaths += 1
        if event in _ROUTER_EVENTS:
            self.last_decision = rec
        return True

    @property
    def routable(self) -> int:
        return sum(1 for s in self.replicas.values() if s == "up")

    @property
    def shed_per_min(self) -> float:
        """Sheds per minute over the trailing event-time window (event
        time, not wall time — a finished ledger renders its own end)."""
        if not self._shed_times or not self.latest_time:
            return 0.0
        cutoff = self.latest_time - FLEET_RATE_WINDOW_S
        n = sum(1 for t in self._shed_times if t > cutoff)
        return n * 60.0 / FLEET_RATE_WINDOW_S


def fleet_line(state: FleetWatchState) -> "str | None":
    """Render the fleet's routing vitals as watch lines: routable
    replicas, router queue depth, windowed shed rate, and the last
    router decision (with its trace id, the hook into `cli trace
    --fleet`). None when no fleet events have been folded (not a
    fleet-parent run dir)."""
    if not state.replicas and not state.last_decision:
        return None
    total = len(state.replicas)
    line = (
        f"  fleet        {state.routable}/{total} routable"
        f"   inflight {_fmt(state.inflight, ',.0f')}"
        f"   sheds {state.sheds:,} ({state.shed_per_min:,.1f}/min)"
        f"   retries {state.retries:,}"
        f"   hedges {state.hedges:,} ({state.hedge_wins:,} won)"
        f"   deaths {state.deaths:,}"
    )
    if state.rungs or state.precisions:
        # One segment per replica that reported a shape: "r0 up b4 int8".
        # Fleets started before rung/precision reporting render nothing
        # extra here (legacy fleet.jsonl stays byte-identical above).
        segs = []
        for name in sorted(set(state.rungs) | set(state.precisions)):
            seg = f"{name} {state.replicas.get(name, '?')}"
            if name in state.rungs:
                seg += f" b{state.rungs[name]}"
            if name in state.precisions:
                seg += f" {state.precisions[name]}"
            segs.append(seg)
        line += "\n  replicas     " + "   ".join(segs)
    d = state.last_decision
    if d:
        parts = [f"last {d.get('event')}"]
        if d.get("rejection"):
            parts.append(str(d["rejection"]))
        if d.get("replica"):
            parts.append(f"-> {d['replica']}")
        if isinstance(d.get("attempt"), int):
            parts.append(f"attempt {d['attempt']}")
        tid = d.get("trace_id")
        if isinstance(tid, str) and tid:
            parts.append(f"trace {tid[:8]}…")
        line += "\n  router       " + " ".join(parts)
    return line


def health_line(health: "dict | None", now: "float | None" = None) -> "str | None":
    """Render the heartbeat (`health.json`, telemetry.HealthMonitor) as
    one liveness line with an explicit stall verdict: heartbeat age past
    the watchdog deadline, or a watchdog-flagged stall, both render as
    STALLED. None when no heartbeat exists (pre-telemetry run)."""
    if not isinstance(health, dict) or "time" not in health:
        return None
    now = time.time() if now is None else now
    age = max(0.0, now - float(health.get("time") or 0.0))
    deadline = float(health.get("watchdog_deadline_s") or 300.0)
    step = health.get("learner_step") or 0
    if age > deadline:
        return f"  health       STALLED (no heartbeat for {age:,.0f}s)"
    if health.get("stalled"):
        return (
            "  health       STALLED (watchdog: no training progress; "
            f"heartbeat {age:,.0f}s ago)"
        )
    return (
        f"  health       live (heartbeat {age:,.0f}s ago, "
        f"learner step {step:,})"
    )


def _gib(value: "float | None") -> str:
    if not isinstance(value, (int, float)):
        return "—"
    return f"{value / 2**30:,.2f} GiB"


def memory_line(util: dict) -> "str | None":
    """Render the newest utilization record's device-memory fields
    (in-use / run-peak / % of limit) as one watch
    line; None when the record predates memory accounting."""
    in_use = util.get("mem_bytes_in_use")
    if not isinstance(in_use, (int, float)):
        return None
    peak = util.get("mem_peak_bytes_in_use")
    limit = util.get("mem_bytes_limit")
    pct = util.get("mem_utilization")
    line = f"  memory       {_gib(in_use)} in use   peak {_gib(peak)}"
    if isinstance(limit, (int, float)) and limit:
        line += f"   limit {_gib(limit)}"
        if isinstance(pct, (int, float)):
            line += f" ({pct:.1%})"
    return line


def device_stats_line(util: dict) -> "str | None":
    """Render the newest util record's device-stats gauges (the
    in-program stat-pack mirror — telemetry/device_stats.py) as one
    watch line; None when the run predates the plane or has it off."""
    entropy = util.get("root_visit_entropy")
    occupancy = util.get("tree_occupancy")
    if not isinstance(entropy, (int, float)) and not isinstance(
        occupancy, (int, float)
    ):
        return None
    line = (
        f"  search       root entropy {_fmt(entropy, ',.2f')}"
        f"   tree occupancy {_fmt(occupancy * 100 if isinstance(occupancy, (int, float)) else None, ',.0f', '%')}"
    )
    if util.get("beacons_armed"):
        line += "   BEACONS ARMED"
    return line


def idle_line(util: dict) -> "str | None":
    """Render the newest util record's idle gauge (the fraction of the
    last tick window with no dispatch in flight) as one watch line; None
    when the record has none (the flight ring off)."""
    idle = util.get("chip_idle_fraction")
    if not isinstance(idle, (int, float)):
        return None
    line = f"  roofline     chip idle {_fmt(idle * 100, ',.1f', '%')}"
    if idle >= 0.5:
        line += "  — HOST-BOUND?"
    return line


def last_dispatch_line(
    state: WatchState, now: "float | None" = None
) -> "str | None":
    """Render the flight ring's freshest record as one line: the
    program in flight right now (age vs expected/deadline — the wedge
    early-warning), or the last sealed program's measured wall. None
    when the run has no flight records (recorder off or pre-flight)."""
    intent, seal = state.flight_intent, state.flight_seal
    if not intent and not seal:
        return None
    now = time.time() if now is None else now
    in_flight = bool(intent) and (
        not seal or (intent.get("seq", -1) or 0) > (seal.get("seq", -1) or 0)
    )
    if in_flight:
        t = intent.get("time")
        age = max(0.0, now - float(t)) if isinstance(t, (int, float)) else None
        expected = intent.get("expected_s")
        deadline = intent.get("deadline_s")
        line = (
            f"  dispatch     {intent.get('program')} "
            f"[{intent.get('family')}] in flight"
            f" {_fmt(age, ',.0f', 's')}"
        )
        if isinstance(expected, (int, float)):
            line += f"   expected {expected:,.1f}s"
        if isinstance(deadline, (int, float)):
            line += f"   deadline {deadline:,.0f}s"
            if age is not None and age > deadline:
                line += "  — OVER DEADLINE"
        return line
    t = seal.get("time")
    age = max(0.0, now - float(t)) if isinstance(t, (int, float)) else None
    ok = seal.get("ok", True)
    return (
        f"  dispatch     {seal.get('program')} [{seal.get('family')}]"
        f" sealed {_fmt(age, ',.0f', 's')} ago"
        f"   wall {_fmt(seal.get('wall_s'), ',.2f', 's')}"
        + ("" if ok else "  — ERROR")
    )


def render_frame(
    state: WatchState, run_name: str, health: "dict | None" = None
) -> str:
    """One console frame: the run's vital signs, newest tick first."""
    m = state.latest
    age = state.age_seconds
    stale = age is not None and age > 300
    lines = [
        f"run {run_name} @ step {state.latest_step:,}"
        + (
            f"   (last tick {_fmt(age, ',.0f', 's')} ago"
            + (" — STALLED?)" if stale else ")")
            if age is not None
            else ""
        ),
        "",
        f"  self-play    {_fmt(state.games_per_hour, ',.0f')} games/h"
        f"   episodes {_fmt(m.get('Progress/Episodes_Played'), ',.0f')}"
        f"   score {_fmt(m.get('SelfPlay/Episode_Score'), ',.2f')}"
        f"   len {_fmt(m.get('SelfPlay/Episode_Length'), ',.1f')}",
        f"  learner      {_fmt(state.steps_per_sec, ',.2f')} steps/s"
        f"   loss {_fmt(m.get('Loss/total_loss'), ',.4f')}"
        f"   grad-norm {_fmt(m.get('Loss/Grad_Norm'), ',.3f')}",
        f"  replay       ratio {_fmt(m.get('System/Replay_Ratio_Actual'), ',.3f')}"
        f"   buffer {_fmt(m.get('Buffer/Size'), ',.0f')}"
        f"   staleness {_fmt(m.get('SelfPlay/Staleness_Steps'), ',.1f')} steps",
        f"  pipeline     queue {_fmt(m.get('System/Rollout_Queue_Depth'), ',.1f')}"
        f"   producer restarts {_fmt(m.get('System/Producer_Restarts'), ',.0f')}"
        f"   full-search {_fmt(m.get('SelfPlay/Full_Search_Fraction'), ',.2f')}",
    ]
    u = state.util
    if u:
        mfu = u.get("mfu")
        lines.append(
            f"  utilization  MFU {_fmt(mfu * 100 if mfu is not None else None, ',.2f', '%')}"
            f"   {_fmt(u.get('tflops_per_sec'), ',.2f')} TFLOP/s"
            f"   step {_fmt(u.get('step_time_ms'), ',.0f', 'ms')}"
            f"   xfer h2d {_fmt(u.get('transfer_h2d_ms'), ',.0f', 'ms')}"
            f" d2h {_fmt(u.get('transfer_d2h_ms'), ',.0f', 'ms')}"
        )
        mline = memory_line(u)
        if mline is not None:
            lines.append(mline)
        dsline = device_stats_line(u)
        if dsline is not None:
            lines.append(dsline)
        iline = idle_line(u)
        if iline is not None:
            lines.append(iline)
    dline = last_dispatch_line(state)
    if dline is not None:
        lines.append(dline)
    hline = health_line(health)
    if hline is not None:
        lines.append(hline)
    return "\n".join(lines)


def tail_jsonl(path: Path, fold, offset: int = 0) -> int:
    """Fold JSONL lines appended past `offset`; returns the new offset.

    Tolerates the file not existing yet (run still compiling), a torn
    final line (kept un-consumed and reread next tick — a line only
    counts once its newline lands), junk bytes inside a line (the fold
    callbacks reject them), and undecodable bytes (replaced, so a
    partially-written multibyte character can't raise)."""
    try:
        size = path.stat().st_size
    except OSError:
        return offset
    if size <= offset:
        # Truncated (fresh run reusing the dir) — start over.
        return 0 if size < offset else offset
    try:
        with path.open("r", errors="replace") as f:
            f.seek(offset)
            chunk = f.read()
    except OSError:
        return offset
    # Keep a torn trailing line for the next read.
    end = chunk.rfind("\n")
    if end < 0:
        return offset
    for line in chunk[: end + 1].splitlines():
        fold(line)
    return offset + end + 1


def tail_live_metrics(
    path: Path,
    state: WatchState,
    offset: int = 0,
) -> int:
    """Fold `live_metrics.jsonl` ticks appended past `offset`."""
    return tail_jsonl(path, state.fold_line, offset)


def tail_ledger_utils(
    path: Path,
    state: WatchState,
    offset: int = 0,
) -> int:
    """Fold `metrics.jsonl` utilization records appended past `offset`."""
    return tail_jsonl(path, state.fold_util_line, offset)


def tail_flight(
    path: Path,
    state: WatchState,
    offset: int = 0,
) -> int:
    """Fold `flight.jsonl` dispatch records appended past `offset`."""
    return tail_jsonl(path, state.fold_flight_line, offset)


def tail_fleet(
    path: Path,
    state: FleetWatchState,
    offset: int = 0,
) -> int:
    """Fold `fleet.jsonl` events appended past `offset`."""
    return tail_jsonl(path, state.fold_fleet_line, offset)


def find_latest_run_dir(runs_root: Path) -> "Path | None":
    """The most recently modified run dir under the runs root (the
    host-side twin of CheckpointManager.find_latest_run, importable
    without torch)."""
    try:
        candidates = [p for p in runs_root.iterdir() if p.is_dir()]
    except OSError:
        return None
    if not candidates:
        return None

    def mtime(p: Path) -> float:
        # A run dir can be deleted (cleanup, tmpdir teardown) between
        # the listing above and this stat; treat it as infinitely old
        # instead of crashing `cli watch` at startup.
        try:
            return p.stat().st_mtime
        except OSError:
            return 0.0

    return max(candidates, key=mtime)
