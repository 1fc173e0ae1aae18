"""Dispatch flight recorder: counterpart of `alphatriangle_tpu/telemetry/
flight.py`, with the same `flight.jsonl` records and verdicts, so
either package's readers classify the other's run directories.

- `FlightRecorder`: before each bracketed dispatch (a fleet replica's
  `serve/b<B>` search, the router's `fleet/route`) an *intent* record
  (program, avals, expected duration from this run's own sealed
  history, deadline) is appended to `flight.jsonl`; after it, a *seal*
  with the measured wall. A serve dispatch seals after its one host
  fetch, so the wall covers the kernels, not only their launches. An
  intent without a seal names the program the process died inside.
- `DispatchWatchdog`: armed per intent, disarmed per seal. Past
  `warn_fraction` of its deadline a dispatch warns once (`on_warn`:
  telemetry arms the progress beacons). Past the deadline it dumps
  every thread's stack, runs the caller hook (span trace flush),
  writes `wedge_report.json` with the run's `last_beacon` (the card's
  beacon ring drained first) and exits with `WEDGE_EXIT_CODE` (113), so
  a supervisor respawns in seconds. Under `ALPHATRIANGLE_FAULTS` the
  chaos drills' `dispatch` site (`supervise/faults.py`: hang-dispatch,
  corrupt-ring) fires in `begin`, once the intent is written and the
  watchdog armed.
- Readers (`read_flight`, `unsealed_intents`, `summarize_flight`,
  `classify_run`): stdlib only, so a parent beside a wedged card reads
  them without torch.

Records:

    {"kind": "flight", "phase": "intent", "seq": N, "program": ...,
     "family": ..., "avals": ..., "expected_s": ..., "deadline_s": ...,
     "t_mono": ..., "time": ..., "pid": ...}
    {"kind": "flight", "phase": "seal", "seq": N, "program": ...,
     "family": ..., "wall_s": ..., "ok": true, "t_mono": ..., "time": ...}

A failed dispatch seals `ok: false` with its `error`.
"""

import contextlib
import json
import logging
import os
import threading
import time
from pathlib import Path

from .ledger import MetricsLedger, iter_jsonl_records, ledger_paths

logger = logging.getLogger(__name__)

FLIGHT_FILENAME = "flight.jsonl"
WEDGE_REPORT_FILENAME = "wedge_report.json"
WEDGE_STACKS_FILENAME = "wedge_stacks.txt"
PREEMPT_REPORT_FILENAME = "preempt_report.json"

# Distinct exit code for a dispatch-deadline wedge, chosen outside the
# shell/signal ranges (1/2, 126-165): a supervisor seeing it KNOWS the
# process killed itself over a hung device program, not a crash.
WEDGE_EXIT_CODE = 113

# Exit code for a SIGTERM preemption the training loop absorbed: the
# emergency checkpoint + buffer spill + ledger flush all completed and
# preempt_report.json is on disk. A supervisor seeing 114 restarts (or
# doesn't — the host is being reclaimed) without treating it as a crash.
PREEMPT_EXIT_CODE = 114

# Exit code of a supervisor whose restart budget or circuit breaker
# tripped: the child is sick in a way restarts do not fix.
SUPERVISOR_GIVEUP_EXIT_CODE = 115

# Memory pressure at/above this fraction of the device limit makes the
# doctor call a wedged/stalled run OOM rather than generically hung.
OOM_UTILIZATION = 0.92

# EWMA weight for per-program expected durations: heavy enough to track
# a run warming up, light enough that one slow dispatch doesn't triple
# the next deadline.
_EWMA_ALPHA = 0.3


def program_family(program: str) -> str:
    """Dispatch family of a program name: the hot families get stable
    labels; anything else keys by its name head."""
    head = str(program).split("/", 1)[0]
    if head == "self_play_chunk":
        return "rollout"
    if head.startswith("learner"):
        return "learner"
    if head == "megastep":
        return "megastep"
    if head == "serve":
        return "serve"
    if head == "fleet":
        # Router dispatch brackets (`fleet/route`, serving/router.py):
        # host-side fan-out, but bracketed the same way so an unsealed
        # route names the request the fleet parent died holding.
        return "fleet"
    if head == "reuse":
        # Standalone subtree-promotion programs (`reuse/promote_*`,
        # ops/subtree_reuse.py): the training/serve paths fuse the
        # promotion into their own dispatches, but the parity bench and
        # smoke run it as its own hot program — same forensics contract.
        return "reuse"
    return head


class FlightSpan:
    """One armed dispatch: seal exactly once (idempotent)."""

    __slots__ = (
        "recorder", "seq", "program", "family", "t0", "trace", "_sealed",
    )

    def __init__(
        self,
        recorder,
        seq: int,
        program: str,
        family: str,
        t0: float,
        trace: "dict | None" = None,
    ):
        self.recorder = recorder
        self.seq = seq
        self.program = program
        self.family = family
        self.t0 = t0
        self.trace = trace
        self._sealed = False

    def seal(self, error: "str | None" = None) -> None:
        if self._sealed:
            return
        self._sealed = True
        self.recorder._seal(self, error=error)


class FlightRecorder:
    """Intent/seal writer + per-program expected-duration model.

    Thread-safe: several threads may dispatch concurrently (the
    overlapped loop's producers, each on its own CUDA stream, beside the
    learner); the counters and the expected walls, keyed by program name,
    update under the recorder's lock, and each append under the ledger's.
    The cost per dispatch is two `MetricsLedger.append`s
    (open/write/flush/close each), accumulated in `overhead_seconds`.

    `sealed_wall_seconds` sums the walls of the sealed spans, so spans
    open at the same time on several threads count once each;
    `inflight_wall_s()` is the union: the seconds in which at least one
    span was open.
    """

    def __init__(
        self,
        path: Path | str,
        max_bytes: int = 8 * 1024 * 1024,
        keep: int = 1,
        deadline_factor: float = 10.0,
        min_deadline_s: float = 60.0,
        first_deadline_s: float = 900.0,
        watchdog: "DispatchWatchdog | None" = None,
        base_trace: "dict | None" = None,
    ) -> None:
        self.path = Path(path)
        # Default trace fields for every bracket that doesn't pass its
        # own: RunTelemetry sets this from the env seam so a spawned
        # child's dispatches link back to the supervisor attempt that
        # spawned it (telemetry/tracectx.py).
        self.base_trace = dict(base_trace) if base_trace else None
        self._ledger = MetricsLedger(self.path, max_bytes=max_bytes, keep=keep)
        self.deadline_factor = deadline_factor
        self.min_deadline_s = min_deadline_s
        self.first_deadline_s = first_deadline_s
        self.watchdog = watchdog
        self.overhead_seconds = 0.0
        self.sealed_wall_seconds = 0.0
        self.dispatches = 0
        self._lock = threading.Lock()
        self._seq = 0
        # The union of the open spans [t0, seal]: how many are open, the
        # current stretch's start and latest seal, where the last stretch
        # ended (a span that began before that, on another thread, but
        # took the lock after it, starts its stretch there), and the
        # closed stretches' total.
        self._open = 0
        self._open_since = 0.0
        self._stretch_end = 0.0
        self._last_close = 0.0
        self._inflight_closed_s = 0.0
        self._expected: dict[str, float] = {}
        # A resumed run inherits its predecessors' measured durations:
        # the first dispatch of a warm program gets a calibrated
        # deadline instead of the generous compile allowance.
        for rec in read_flight(self.path):
            if rec.get("phase") == "seal" and rec.get("ok", True):
                wall = rec.get("wall_s")
                if isinstance(wall, (int, float)) and wall > 0:
                    self._fold_expected(str(rec.get("program")), float(wall))

    def _fold_expected(self, program: str, wall_s: float) -> None:
        prev = self._expected.get(program)
        self._expected[program] = (
            wall_s
            if prev is None
            else (1 - _EWMA_ALPHA) * prev + _EWMA_ALPHA * wall_s
        )

    def expected_s(self, program: str) -> "float | None":
        with self._lock:
            return self._expected.get(program)

    def deadline_s(self, expected: "float | None") -> float:
        """Watchdog deadline for one dispatch: N x the expected wall
        (floored), or the generous first-dispatch allowance when no
        history exists — a first dispatch includes its compile."""
        if expected is None:
            return self.first_deadline_s
        return max(self.min_deadline_s, self.deadline_factor * expected)

    def begin(
        self,
        family: str,
        program: str,
        avals: "str | None" = None,
        trace: "dict | None" = None,
    ) -> FlightSpan:
        """Write the intent record and arm the watchdog; call BEFORE
        the dispatch. Returns the span to `seal()` after the fetch.

        `trace` is an optional dict of trace-context fields
        (trace_id/span_id/... or trace_ids for a batched wave) merged
        into BOTH the intent and the seal record, so an unsealed
        intent names not just the hung program but the exact request(s)
        it was serving (telemetry/tracectx.py)."""
        t_host = time.perf_counter()
        with self._lock:
            self._seq += 1
            seq = self._seq
            expected = self._expected.get(program)
        deadline = self.deadline_s(expected)
        trace = trace if trace else self.base_trace
        record = {
            "kind": "flight",
            "phase": "intent",
            "seq": seq,
            "program": program,
            "family": family,
            "avals": avals,
            "expected_s": (
                round(expected, 6) if expected is not None else None
            ),
            "deadline_s": round(deadline, 3),
            "t_mono": time.monotonic(),
            "time": time.time(),
            "pid": os.getpid(),
        }
        if trace:
            record.update(trace)
        self._ledger.append(record)
        if self.watchdog is not None:
            self.watchdog.arm(
                seq,
                program=program,
                family=family,
                deadline_s=deadline,
                expected_s=expected,
                avals=avals,
            )
        if os.environ.get("ALPHATRIANGLE_FAULTS"):
            # The chaos drills' dispatch site (supervise/faults.py): it
            # fires after the intent is durable and the watchdog is armed,
            # so an injected hang dies as a wedged dispatch does.
            from ..supervise.faults import fault_point

            fault_point("dispatch", seq, flight_path=self.path)
        span = FlightSpan(
            self, seq, program, family, time.perf_counter(), trace=trace
        )
        with self._lock:
            self.overhead_seconds += span.t0 - t_host
            if self._open == 0:
                self._open_since = self._stretch_end = max(span.t0, self._last_close)
            self._open += 1
        return span

    def inflight_wall_s(self) -> float:
        """Seconds so far with at least one span open, the open ones up
        to now included."""
        with self._lock:
            total = self._inflight_closed_s
            if self._open:
                total += max(0.0, time.perf_counter() - self._open_since)
            return total

    def _seal(self, span: FlightSpan, error: "str | None" = None) -> None:
        t_host = time.perf_counter()
        wall = t_host - span.t0
        if self.watchdog is not None:
            self.watchdog.disarm(span.seq)
        record = {
            "kind": "flight",
            "phase": "seal",
            "seq": span.seq,
            "program": span.program,
            "family": span.family,
            "wall_s": round(wall, 6),
            "ok": error is None,
            "t_mono": time.monotonic(),
            "time": time.time(),
        }
        if span.trace:
            record.update(span.trace)
        if error is not None:
            record["error"] = error
        self._ledger.append(record)
        with self._lock:
            self._open -= 1
            self._stretch_end = max(self._stretch_end, t_host)
            if self._open == 0:
                self._inflight_closed_s += self._stretch_end - self._open_since
                self._last_close = self._stretch_end
            if error is None:
                self._fold_expected(span.program, wall)
                self.sealed_wall_seconds += wall
                self.dispatches += 1
            self.overhead_seconds += time.perf_counter() - t_host

    def close(self) -> None:
        """Append the run's overhead summary."""
        with self._lock:
            self._ledger.append(
                {
                    "kind": "flight_overhead",
                    "overhead_s": round(self.overhead_seconds, 6),
                    "sealed_wall_s": round(self.sealed_wall_seconds, 6),
                    "dispatches": self.dispatches,
                    "time": time.time(),
                }
            )


@contextlib.contextmanager
def flight_span(
    recorder: "FlightRecorder | None",
    family: str,
    program: str,
    avals: "str | None" = None,
    trace: "dict | None" = None,
):
    """Intent/seal bracket for a synchronous dispatch site; a no-op
    when the component has no recorder attached (tests, telemetry
    disabled). A raising dispatch seals `ok: false` with the error —
    an *unsealed* intent therefore always means the process died or
    wedged inside the bracket. `trace` rides through to both the
    intent and the seal (see `FlightRecorder.begin`)."""
    if recorder is None:
        yield None
        return
    span = recorder.begin(family, program, avals=avals, trace=trace)
    try:
        yield span
    except BaseException as exc:
        span.seal(error=repr(exc))
        raise
    else:
        span.seal()


class DispatchWatchdog:
    """Per-dispatch deadline enforcement (the stall watchdog's sharper
    sibling: `health.Watchdog` asks "is anything progressing?", this
    asks "is THIS dispatch overdue?").

    Armed by `FlightRecorder.begin`, disarmed by the seal. A dispatch
    past its deadline fires ONCE: faulthandler stacks into
    `wedge_stacks.txt`, the caller hook (trace flush), an atomic
    `wedge_report.json`, then — unless `exit_on_wedge` is off (tests) —
    `os._exit(WEDGE_EXIT_CODE)`. `os._exit` because the
    thread that would run normal shutdown is the one blocked inside the
    hung dispatch. The clock is injectable so tests freeze it.

    A near-deadline warning comes first: a dispatch in flight past
    `warn_fraction` of its deadline (0.5, the JAX config's default; None
    turns the warning off) calls `on_warn` once (telemetry arms the
    progress beacons there, so the work enqueued after it, and a later
    wedge, report their phases); `warn_count` counts them.
    """

    def __init__(
        self,
        run_dir: Path | str,
        poll_s: float = 5.0,
        on_wedge=None,
        exit_on_wedge: bool = True,
        clock=time.monotonic,
        warn_fraction: "float | None" = 0.5,
        on_warn=None,
    ) -> None:
        self.run_dir = Path(run_dir)
        self.poll_s = poll_s
        self.on_wedge = on_wedge
        self.exit_on_wedge = exit_on_wedge
        self.warn_fraction = warn_fraction
        self.on_warn = on_warn
        self.warn_count = 0
        self._clock = clock
        self._lock = threading.Lock()
        self._armed: dict[int, dict] = {}
        self._fired = False
        self.wedge_count = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def arm(self, seq: int, **info) -> None:
        with self._lock:
            self._armed[seq] = {"seq": seq, "armed_at": self._clock(), **info}

    def disarm(self, seq: int) -> None:
        with self._lock:
            self._armed.pop(seq, None)

    def check(self, now: "float | None" = None) -> "dict | None":
        """One deadline evaluation; returns the wedge info when a
        dispatch is overdue (having fired the full reaction), else
        None. Called by the poll thread, and directly by tests."""
        now = self._clock() if now is None else now
        warnings: list[dict] = []
        with self._lock:
            if self._fired:
                return None
            overdue = None
            for info in self._armed.values():
                elapsed = now - info["armed_at"]
                deadline = float(info.get("deadline_s") or 0.0)
                if (
                    self.warn_fraction is not None
                    and not info.get("warned")
                    and deadline > 0.0
                    and elapsed > self.warn_fraction * deadline
                ):
                    # Once per dispatch, before any wedge reaction.
                    info["warned"] = True
                    self.warn_count += 1
                    warnings.append(dict(info, elapsed_s=round(elapsed, 3)))
                if elapsed > deadline and (
                    overdue is None or elapsed > overdue[1]
                ):
                    overdue = (info, elapsed)
            if overdue is not None:
                self._fired = True
                self.wedge_count += 1
        for winfo in warnings:
            logger.warning(
                "DispatchWatchdog: %s (%s) at %.0f%% of its %.0fs deadline (%.0fs elapsed) — "
                "near-deadline warning.",
                winfo.get("program"),
                winfo.get("family"),
                100.0 * winfo["elapsed_s"] / float(winfo["deadline_s"]),
                float(winfo.get("deadline_s") or 0.0),
                winfo["elapsed_s"],
            )
            if self.on_warn is not None:
                try:
                    self.on_warn(winfo)
                except Exception:
                    logger.exception("on_warn hook failed")
        if overdue is None:
            return None
        info, elapsed = overdue
        return self._fire(dict(info), elapsed)

    def _fire(self, info: dict, elapsed: float) -> dict:
        info["elapsed_s"] = round(elapsed, 3)
        logger.error(
            "DispatchWatchdog: %s (%s) in flight %.0fs past its %.0fs "
            "deadline — the device program is wedged.",
            info.get("program"),
            info.get("family"),
            elapsed,
            float(info.get("deadline_s") or 0.0),
        )
        stacks_path = self.run_dir / WEDGE_STACKS_FILENAME
        try:
            from .health import dump_thread_stacks

            dump_thread_stacks(stacks_path)
        except Exception:
            logger.exception("wedge stack dump failed")
        if self.on_wedge is not None:
            try:
                self.on_wedge(info)
            except Exception:
                logger.exception("on_wedge hook failed")
        report = {
            "kind": "wedge",
            "time": time.time(),
            "pid": os.getpid(),
            "program": info.get("program"),
            "family": info.get("family"),
            "seq": info.get("seq"),
            "avals": info.get("avals"),
            "expected_s": info.get("expected_s"),
            "deadline_s": info.get("deadline_s"),
            "elapsed_s": info.get("elapsed_s"),
            "stacks_file": str(stacks_path),
            "exit_code": WEDGE_EXIT_CODE if self.exit_on_wedge else None,
        }
        try:
            # The newest beacon row (None unless beacons were armed): the
            # phase the hung work, or the work before it, last reached.
            # The card's ring is drained first.
            from .device_stats import drain_beacons, last_beacon

            drain_beacons()
            report["last_beacon"] = last_beacon(self.run_dir)
        except Exception:
            logger.exception("beacon read for the wedge report failed")
            report["last_beacon"] = None
        write_wedge_report(self.run_dir / WEDGE_REPORT_FILENAME, report)
        if self.exit_on_wedge:
            # Flush logging/stdio by hand: _exit skips atexit and
            # buffered writers, and the report above is already durable.
            logging.shutdown()
            os._exit(WEDGE_EXIT_CODE)
        return report

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="dispatch-watchdog", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.check()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def write_wedge_report(path: Path | str, report: dict) -> bool:
    """Atomic wedge-report write (tmp + replace); never raises."""
    path = Path(path)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(json.dumps(report, indent=2))
        tmp.replace(path)
        return True
    except OSError:
        logger.exception("wedge report write to %s failed", path)
        return False


# --- postmortem readers (stdlib only) ---------------------------------------


def read_flight(path: Path | str) -> list[dict]:
    """All parseable flight records across rotations, oldest first —
    the shared tolerant reader (`iter_jsonl_records`) + the ledger's
    rotation walk; torn tails and junk bytes are skipped, never raised."""
    out = []
    for p in ledger_paths(Path(path)):
        out.extend(iter_jsonl_records(p, kinds={"flight"}))
    return out


def read_wedge_report(path: Path | str) -> "dict | None":
    try:
        report = json.loads(Path(path).read_text())
        return report if isinstance(report, dict) else None
    except (OSError, json.JSONDecodeError):
        return None


def write_preempt_report(path: Path | str, report: dict) -> bool:
    """Atomic preempt-report write — same tmp+replace discipline (and
    never-raises contract) as the wedge report."""
    return write_wedge_report(path, report)


def read_preempt_report(path: Path | str) -> "dict | None":
    return read_wedge_report(path)


def unsealed_intents(records: list) -> list[dict]:
    """Intent records with no seal (any outcome) for their seq — the
    dispatches that were in flight when the process died."""
    sealed = {
        r.get("seq") for r in records if r.get("phase") == "seal"
    }
    return [
        r
        for r in records
        if r.get("phase") == "intent" and r.get("seq") not in sealed
    ]


#: verdict -> `cli doctor` exit code (documented in OBSERVABILITY.md;
#: 1 is left to argparse/usage errors).
DOCTOR_EXIT_CODES = {
    "clean": 0,
    "never-started": 2,
    "compile-hung": 3,
    "dispatch-hung": 4,
    "host-stall": 5,
    "oom": 6,
    "preempted": 7,
}


def summarize_flight(records: list) -> list[dict]:
    """Per-program rows from the sealed records: count, errors (seals
    `ok: false`), wall p50 / p95 / total in seconds, family; busiest
    program first (`cli perf`'s program table and its `--json`
    `programs`)."""
    from .perf import _percentile

    by_program: dict[str, list[float]] = {}
    family: dict[str, str] = {}
    errors: dict[str, int] = {}
    for r in records:
        if r.get("phase") != "seal":
            continue
        program = str(r.get("program"))
        family.setdefault(program, str(r.get("family")))
        if not r.get("ok", True):
            errors[program] = errors.get(program, 0) + 1
            continue
        wall = r.get("wall_s")
        if isinstance(wall, (int, float)):
            by_program.setdefault(program, []).append(float(wall))
    rows = []
    for program in set(by_program) | set(errors):
        walls = by_program.get(program, [])
        rows.append(
            {
                "program": program,
                "family": family.get(program, program_family(program)),
                "count": len(walls),
                "errors": errors.get(program, 0),
                "wall_s_p50": _percentile(walls, 0.50),
                "wall_s_p95": _percentile(walls, 0.95),
                "wall_s_total": round(sum(walls), 6) if walls else 0.0,
            }
        )
    rows.sort(key=lambda r: -r["wall_s_total"])
    return rows


def family_seconds(records: list) -> dict:
    """p50 measured dispatch seconds per family, from the sealed ok
    records: the term the autotuner's `--calibrate` folds in
    (autotune/model.py). The families are the dispatch sites' own
    ("rollout", "learner", "megastep", "serve"), the names
    `program_family` gives the cost records' programs."""
    from .perf import _percentile

    by_family: dict[str, list[float]] = {}
    for r in records:
        if r.get("phase") != "seal" or not r.get("ok", True):
            continue
        wall = r.get("wall_s")
        if isinstance(wall, (int, float)):
            by_family.setdefault(str(r.get("family")), []).append(float(wall))
    return {fam: _percentile(walls, 0.50) for fam, walls in by_family.items()}


def _memory_pressure(health: "dict | None", utils: list) -> "float | None":
    """Device memory utilization from the freshest evidence available:
    the last util record's gauge, else the heartbeat's device table."""
    for u in reversed(utils or []):
        frac = u.get("mem_utilization")
        if isinstance(frac, (int, float)):
            return float(frac)
    for mem in (health or {}).get("device_memory") or []:
        in_use, limit = mem.get("bytes_in_use"), mem.get("bytes_limit")
        if isinstance(in_use, (int, float)) and limit:
            return float(in_use) / float(limit)
    return None


def classify_run(
    flight_records: list,
    health: "dict | None" = None,
    utils: "list | None" = None,
    wedge: "dict | None" = None,
    now: "float | None" = None,
    preempt: "dict | None" = None,
    beacon: "dict | None" = None,
) -> dict:
    """Pure postmortem classifier over a run's on-disk evidence.

    Verdicts, strongest evidence first:

    - `dispatch-hung` / `compile-hung`: a wedge report, or an unsealed
      intent in the flight ring — the exact program is named; "compile"
      when that program never sealed before (its first dispatch, which
      includes the compile), "dispatch" when it had completed before.
    - `oom`: the hang/stall happened with device memory at >=92% of the
      limit — the wedge is a symptom, the allocator is the cause.
    - `host-stall`: every dispatch sealed but the heartbeat says the
      process stalled (or kept beating long after the last seal) — the
      device finished its work and the HOST stopped feeding it.
    - `preempted`: a preempt report is on disk — the loop absorbed a
      SIGTERM, emergency-checkpointed, and exited on purpose. Only a
      hang outranks it (a wedge mid-preemption is still a wedge).
    - `never-started`: no dispatch was ever attempted (no flight
      records) — death before the first dispatch (imports, init,
      checkpoint restore).
    - `clean`: all intents sealed, no stall evidence.

    `beacon` is the run's newest progress-beacon row (`last_beacon`;
    the wedge report's own copy wins when both exist): a hung verdict
    names it in its detail and carries it as `last_beacon`.

    Returns {verdict, exit_code, program, family, detail, evidence};
    hung verdicts add `last_beacon` when a beacon row exists.
    """
    records = flight_records or []
    seals_by_program: dict[str, int] = {}
    for r in records:
        if r.get("phase") == "seal" and r.get("ok", True):
            p = str(r.get("program"))
            seals_by_program[p] = seals_by_program.get(p, 0) + 1
    torn = unsealed_intents(records)
    pressure = _memory_pressure(health, utils or [])
    evidence = {
        "intents": sum(1 for r in records if r.get("phase") == "intent"),
        "seals": sum(1 for r in records if r.get("phase") == "seal"),
        "unsealed": len(torn),
        "mem_utilization": pressure,
        "wedge_report": wedge is not None,
        "preempt_report": preempt is not None,
        "stalled": bool((health or {}).get("stalled")),
    }

    def result(verdict, program=None, family=None, detail=""):
        return {
            "verdict": verdict,
            "exit_code": DOCTOR_EXIT_CODES[verdict],
            "program": program,
            "family": family,
            "detail": detail,
            "evidence": evidence,
        }

    hung = None  # (program, family, detail)
    if wedge is not None:
        program = str(wedge.get("program"))
        hung = (
            program,
            wedge.get("family") or program_family(program),
            "watchdog wedge report: in flight "
            f"{wedge.get('elapsed_s')}s past a "
            f"{wedge.get('deadline_s')}s deadline",
        )
    elif torn:
        intent = torn[-1]
        program = str(intent.get("program"))
        expected = intent.get("expected_s")
        hung = (
            program,
            intent.get("family") or program_family(program),
            "unsealed intent (seq "
            f"{intent.get('seq')}, avals {intent.get('avals')}, "
            f"expected {expected}s)",
        )
    if hung is not None:
        program, family, detail = hung
        beacon_row = (wedge or {}).get("last_beacon") or beacon
        if isinstance(beacon_row, dict):
            from .device_stats import describe_beacon

            described = describe_beacon(beacon_row)
            if described:
                detail = f"{detail}; last beacon: {described}"
        if pressure is not None and pressure >= OOM_UTILIZATION:
            verdict_dict = result(
                "oom",
                program,
                family,
                f"{detail}; device memory at {pressure:.0%} of limit",
            )
        else:
            verdict = (
                "dispatch-hung"
                if seals_by_program.get(program, 0) > 0
                else "compile-hung"
            )
            verdict_dict = result(verdict, program, family, detail)
        if isinstance(beacon_row, dict):
            verdict_dict["last_beacon"] = beacon_row
        return verdict_dict
    if preempt is not None:
        ckpt = preempt.get("checkpointed_step")
        return result(
            "preempted",
            detail="preempt report: SIGTERM absorbed at step "
            f"{preempt.get('step')}, emergency checkpoint at step "
            f"{ckpt} — restart resumes there",
        )
    if not records:
        return result(
            "never-started",
            detail="no flight records: the run died before its first "
            "dispatch (imports, init, or checkpoint restore)",
        )
    if health is not None:
        if health.get("stalled"):
            if pressure is not None and pressure >= OOM_UTILIZATION:
                return result(
                    "oom",
                    detail="stall flagged with device memory at "
                    f"{pressure:.0%} of limit",
                )
            return result(
                "host-stall",
                detail="every dispatch sealed but the watchdog flagged "
                "a stall — the host stopped feeding the device",
            )
        deadline = float(health.get("watchdog_deadline_s") or 300.0)
        last_seal_t = max(
            (
                r.get("time")
                for r in records
                if r.get("phase") == "seal"
                and isinstance(r.get("time"), (int, float))
            ),
            default=None,
        )
        beat_t = health.get("time")
        if (
            last_seal_t is not None
            and isinstance(beat_t, (int, float))
            and beat_t - last_seal_t > 2 * deadline
        ):
            return result(
                "host-stall",
                detail="heartbeat kept beating "
                f"{beat_t - last_seal_t:.0f}s past the last sealed "
                "dispatch — the host loop ran without dispatching",
            )
    return result("clean", detail="every recorded dispatch sealed")
