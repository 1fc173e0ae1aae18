"""Run liveness: counterpart of `alphatriangle_tpu/telemetry/health.py`,
writing and reading the same `health.json`.

- `HealthMonitor`: the run beats it (a served request, a learner step)
  with O(1) lock-guarded field updates; the heartbeat thread or the
  loop's tick writes `health.json` into the run directory atomically:
  last progress ages, the latest utilization record, the card's memory.
- `Watchdog`: a daemon thread that fires once per stall when nothing
  progressed for a deadline, dumping every thread's stack and marking
  the heartbeat stalled, then re-arms when progress resumes.
- `probe_run`: the one liveness probe the fleet's admission gate uses,
  combining heartbeat freshness with the flight ring's unsealed intents
  past their deadline. Stdlib only, like every reader here.
"""

import faulthandler
import json
import logging
import os
import threading
import time
from pathlib import Path

logger = logging.getLogger(__name__)


def device_memory_stats() -> list[dict]:
    """Per-card memory snapshot from the caching allocator: bytes in use
    and their peak (`torch.cuda.memory_stats`), the card's total as the
    limit (`torch.cuda.mem_get_info`). Imports torch lazily, so the
    heartbeat's readers (the fleet parent among them) never load it, and
    reads nothing until this process has a CUDA context: it never
    creates one. Empty on the CPU."""
    try:
        import torch

        if not torch.cuda.is_initialized():
            return []
        out = []
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out.append(
                {
                    "device": i,
                    "kind": torch.cuda.get_device_name(i),
                    "bytes_in_use": stats.get("allocated_bytes.all.current"),
                    "bytes_limit": torch.cuda.mem_get_info(i)[1],
                    "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
                }
            )
        return out
    except Exception:
        return []


class HealthMonitor:
    """Lock-guarded liveness state + atomic `health.json` writer."""

    def __init__(
        self,
        path: Path,
        deadline_s: float = 300.0,
        run_name: str = "",
        clock=time.monotonic,
    ) -> None:
        self.path = Path(path)
        self.deadline_s = deadline_s
        self.run_name = run_name
        self._clock = clock
        self._lock = threading.Lock()
        self._started = clock()
        self._learner_step = 0
        self._last_learner: float | None = None
        self._last_rollout: float | None = None
        self._buffer_size = 0
        self._episodes = 0
        self._experiences = 0
        self._stalled = False
        self._stall_count = 0
        # Device identity + live utilization (telemetry/perf.py): the
        # heartbeat carries what the chip is and how hard it is being
        # driven.
        self._device_kind: str | None = None
        self._peak_tflops: float | None = None
        self._peak_source: str | None = None
        self._utilization: dict | None = None

    # --- beats (any thread, O(1)) -------------------------------------

    def note_learner_step(self, step: int) -> None:
        with self._lock:
            self._learner_step = step
            self._last_learner = self._clock()

    def note_rollout(self, experiences: int = 0, episodes: int = 0) -> None:
        with self._lock:
            self._last_rollout = self._clock()
            self._experiences += experiences
            self._episodes += episodes

    def note_buffer(self, size: int) -> None:
        with self._lock:
            self._buffer_size = size

    def set_device_info(
        self,
        device_kind: str,
        peak_tflops: float | None,
        peak_source: str | None = None,
    ) -> None:
        with self._lock:
            self._device_kind = device_kind
            self._peak_tflops = peak_tflops
            self._peak_source = peak_source

    def note_utilization(self, record: dict) -> None:
        """Latest derived utilization record (telemetry/perf.py); the
        heartbeat carries a trimmed copy."""
        keep = (
            "step",
            "learner_steps_per_sec",
            "step_time_ms",
            "moves_per_sec",
            "games_per_hour",
            "tflops_per_sec",
            "mfu",
            "buffer_fill",
            "transfer_h2d_ms",
            "transfer_d2h_ms",
            "compile_cache_hit_rate",
            "mem_bytes_in_use",
            "mem_peak_bytes_in_use",
            "mem_bytes_limit",
            "mem_utilization",
            # Policy-service SLO fields (serving/service.py): the serve
            # heartbeat answers "alive AND inside latency budget?".
            "serve_sessions",
            "serve_queue_depth",
            "serve_requests_per_sec",
            "serve_move_latency_ms_p50",
            "serve_move_latency_ms_p95",
            "serve_queue_wait_ms_p95",
            "serve_batch_fill",
            "serve_weight_reloads",
        )
        trimmed = {k: record.get(k) for k in keep if k in record}
        with self._lock:
            self._utilization = trimmed

    def set_stalled(self, stalled: bool) -> None:
        with self._lock:
            if stalled and not self._stalled:
                self._stall_count += 1
            self._stalled = stalled

    # --- queries ------------------------------------------------------

    def last_progress(self) -> float:
        """Monotonic time of the most recent learner/rollout progress
        (run start before either has happened)."""
        with self._lock:
            return max(
                self._started,
                self._last_learner or self._started,
                self._last_rollout or self._started,
            )

    def snapshot(self) -> dict:
        """The heartbeat payload (ages computed at snapshot time)."""
        now = self._clock()
        with self._lock:
            return {
                "run": self.run_name,
                "pid": os.getpid(),
                "time": time.time(),
                "monotonic": now,
                "uptime_s": round(now - self._started, 3),
                "learner_step": self._learner_step,
                "learner_age_s": (
                    round(now - self._last_learner, 3)
                    if self._last_learner is not None
                    else None
                ),
                "rollout_age_s": (
                    round(now - self._last_rollout, 3)
                    if self._last_rollout is not None
                    else None
                ),
                "buffer_size": self._buffer_size,
                "episodes_played": self._episodes,
                "experiences_added": self._experiences,
                "stalled": self._stalled,
                "stall_count": self._stall_count,
                "watchdog_deadline_s": self.deadline_s,
                "device_kind": self._device_kind,
                "peak_bf16_tflops": self._peak_tflops,
                "peak_source": self._peak_source,
                "utilization": self._utilization,
                "device_memory": device_memory_stats(),
            }

    def write(self) -> None:
        """Atomic heartbeat write; failures logged, never raised."""
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.path.with_suffix(".json.tmp")
            tmp.write_text(json.dumps(self.snapshot(), indent=2))
            tmp.replace(self.path)
        except OSError:
            logger.exception("heartbeat write to %s failed", self.path)


class Watchdog:
    """Fires once per stall when no progress beats for `deadline_s`."""

    def __init__(
        self,
        health: HealthMonitor,
        deadline_s: float,
        poll_s: float = 10.0,
        on_stall=None,
        on_recover=None,
        clock=time.monotonic,
    ) -> None:
        self.health = health
        self.deadline_s = deadline_s
        self.poll_s = poll_s
        self.on_stall = on_stall
        self.on_recover = on_recover
        self._clock = clock
        self._stalled = False
        self.stall_count = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def check(self, now: float | None = None) -> bool:
        """One stall evaluation; returns whether currently stalled.
        Called by the poll thread, and directly by tests (frozen clock).
        """
        now = self._clock() if now is None else now
        age = now - self.health.last_progress()
        if age > self.deadline_s:
            if not self._stalled:
                self._stalled = True
                self.stall_count += 1
                self.health.set_stalled(True)
                logger.warning(
                    "Watchdog: no learner/rollout progress for %.0fs "
                    "(deadline %.0fs).",
                    age,
                    self.deadline_s,
                )
                if self.on_stall is not None:
                    try:
                        self.on_stall(age)
                    except Exception:
                        logger.exception("watchdog on_stall hook failed")
        elif self._stalled:
            self._stalled = False
            self.health.set_stalled(False)
            logger.info("Watchdog: progress resumed; stall cleared.")
            if self.on_recover is not None:
                try:
                    self.on_recover()
                except Exception:
                    logger.exception("watchdog on_recover hook failed")
        return self._stalled

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="telemetry-watchdog", daemon=True
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


def dump_thread_stacks(path: Path) -> None:
    """Append every thread's current stack to `path` (faulthandler)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("a") as f:
        f.write(
            f"=== stall at {time.strftime('%Y-%m-%d %H:%M:%S')} "
            f"(pid {os.getpid()}) ===\n"
        )
        faulthandler.dump_traceback(file=f, all_threads=True)
        f.write("\n")


# --- heartbeat readers (stdlib only) ----------------------------------------


def read_health(path: Path) -> dict | None:
    """Parse a heartbeat file; None when missing or torn."""
    try:
        return json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError):
        return None


def health_verdict(
    payload: dict,
    now: float | None = None,
    deadline_s: float | None = None,
) -> tuple[bool, float, str]:
    """(live, heartbeat_age_s, reason) for a heartbeat payload.

    Stale heartbeat => the writing process is dead or fully wedged;
    fresh heartbeat with `stalled` set => alive but making no progress.
    Either way the run needs attention.
    """
    now = time.time() if now is None else now
    deadline = (
        deadline_s
        if deadline_s is not None
        else float(payload.get("watchdog_deadline_s") or 300.0)
    )
    age = max(0.0, now - float(payload.get("time") or 0.0))
    if age > deadline:
        return False, age, f"no heartbeat for {age:.0f}s"
    if payload.get("stalled"):
        return False, age, "watchdog flagged a stall (no training progress)"
    return True, age, "live"


# The probe's codes, shared by the fleet's admission gate
# (serving/fleet.py) and any external readiness check; the same values
# as the JAX package's.
PROBE_LIVE = 0
PROBE_UNHEALTHY = 1  # stale heartbeat or watchdog-flagged stall
PROBE_MISSING = 2  # no readable health.json
PROBE_DISPATCH_OVERDUE = 3  # unsealed flight intent past its deadline


def probe_run(
    run_dir: Path,
    now: float | None = None,
    deadline_s: float | None = None,
    dispatch_slack_s: float = 2.0,
) -> dict:
    """Machine-readable liveness probe for one run dir (stdlib only).

    Combines the two independent death signals this repo records:
    heartbeat freshness (`health.json`, written by RunTelemetry) and
    the flight ring's unsealed-intent-past-deadline check — a process
    can heartbeat happily from a side thread while its dispatch thread
    is wedged inside a device program, and only the flight ring sees
    that. Returns a one-line-JSON-able payload whose `code` field is
    the process exit code contract above; `dispatch_slack_s` grace
    keeps the probe from racing the in-process DispatchWatchdog."""
    from .flight import FLIGHT_FILENAME, read_flight, unsealed_intents

    run_dir = Path(run_dir)
    now = time.time() if now is None else now
    out: dict = {
        "schema": "alphatriangle.probe.v1",
        "run_dir": str(run_dir),
        "time": now,
    }
    payload = read_health(run_dir / "health.json")
    if payload is None:
        out.update(
            code=PROBE_MISSING,
            verdict="missing",
            reason="no readable health.json",
            heartbeat_age_s=None,
        )
        return out
    live, age, reason = health_verdict(payload, now=now, deadline_s=deadline_s)
    out.update(
        heartbeat_age_s=round(age, 3),
        pid=payload.get("pid"),
        stalled=bool(payload.get("stalled")),
    )
    overdue = []
    health_pid = payload.get("pid")
    for intent in unsealed_intents(read_flight(run_dir / FLIGHT_FILENAME)):
        intent_deadline = intent.get("deadline_s")
        intent_t = intent.get("time")
        if intent_deadline is None or intent_t is None:
            continue
        # A dead incarnation's unsealed intent is the doctor's death
        # evidence, not a verdict on the CURRENT process: without this
        # pid gate a respawned replica would probe dispatch-overdue
        # forever on its predecessor's wedge confession.
        intent_pid = intent.get("pid")
        if (
            health_pid is not None
            and intent_pid is not None
            and intent_pid != health_pid
        ):
            continue
        intent_age = now - float(intent_t)
        if intent_age > float(intent_deadline) + dispatch_slack_s:
            overdue.append(
                {
                    "program": intent.get("program"),
                    "seq": intent.get("seq"),
                    "age_s": round(intent_age, 3),
                    "deadline_s": float(intent_deadline),
                }
            )
    out["overdue"] = overdue
    if overdue:
        out.update(
            code=PROBE_DISPATCH_OVERDUE,
            verdict="dispatch-overdue",
            reason=(
                f"unsealed dispatch past deadline: {overdue[0]['program']} "
                f"({overdue[0]['age_s']:.1f}s > {overdue[0]['deadline_s']:.0f}s)"
            ),
        )
    elif not live:
        out.update(
            code=PROBE_UNHEALTHY,
            verdict="stalled" if payload.get("stalled") else "stale",
            reason=reason,
        )
    else:
        out.update(code=PROBE_LIVE, verdict="live", reason=reason)
    return out
