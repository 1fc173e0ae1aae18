"""The run supervisor (`cli supervise`) and the postmortem `diagnose`:
counterpart of `alphatriangle_tpu/supervise/supervisor.py`.

`Supervisor` runs a training (or league) child, classifies every death
with the evidence `cli doctor` reads (`diagnose`, restricted to the
records of the attempt that died), and applies the `RecoveryPolicy`
verdict -> action matrix: restart from the newest committed checkpoint
after a backoff, with the policy's overrides in the child's environment
(`OVERRIDES_ENV`, applied by `training/runner.py`), or give up with
`SUPERVISOR_GIVEUP_EXIT_CODE` (115). A SIGTERM or SIGINT to the parent
is forwarded to the child, and the parent exits with the child's code.
Between attempts the one-shot reports (wedge, preempt, wedge stacks)
are moved aside, so the next diagnosis cannot read this attempt's.

Every decision goes to `runs/<run>/supervisor.jsonl` as one crash-safe
line (`MetricsLedger`): spawn, death (with its verdict, evidence and the
action taken), give-up, complete, forward-signal, terminated. Each
attempt gets a child of the supervision's trace context, stamped on its
events and handed to the child through the traceparent variable, so its
flight ring links back to the spawn.

The fleet supervisor (`serving/fleet.py`) classifies each replica death
with `diagnose` over the replica's own run directory. Stdlib only: the
parent must outlive a wedged card, so it imports neither torch nor
numpy; the child is where the card lives.
"""

import json
import logging
import os
import signal
import subprocess
import threading
import time
from pathlib import Path

from ..telemetry import tracectx
from ..telemetry.flight import (
    FLIGHT_FILENAME,
    PREEMPT_EXIT_CODE,
    PREEMPT_REPORT_FILENAME,
    SUPERVISOR_GIVEUP_EXIT_CODE,
    WEDGE_REPORT_FILENAME,
    WEDGE_STACKS_FILENAME,
    classify_run,
    read_flight,
    read_preempt_report,
    read_wedge_report,
)
from ..telemetry.ledger import MetricsLedger, read_ledger, resolve_ledger_path
from .policy import RecoveryPolicy

logger = logging.getLogger(__name__)

SUPERVISOR_FILENAME = "supervisor.jsonl"

#: The variable carrying the accumulated recovery overrides to the child
#: (a JSON object; `training/runner.py` applies it onto TrainConfig).
OVERRIDES_ENV = "ALPHATRIANGLE_SUPERVISE_OVERRIDES"


def latest_committed_step(run_dir: Path | str) -> "int | None":
    """The newest checkpoint step a restart can trust, read off the file
    system with the marker rules of `stats/persistence.py` (which this
    torch-free parent cannot import): the newest commit marker when the
    run has any, else the newest step directory with a parseable meta."""
    ckpt_dir = Path(run_dir) / "checkpoints"
    if not ckpt_dir.is_dir():
        return None
    committed = set()
    for p in ckpt_dir.glob("step_*.commit"):
        stem = p.name[len("step_"):-len(".commit")]
        if stem.isdigit():
            committed.add(int(stem))
    if committed:
        return max(committed)
    steps = []
    for p in ckpt_dir.iterdir():
        if not (p.is_dir() and p.name.startswith("step_")):
            continue
        suffix = p.name[len("step_"):]
        if not suffix.isdigit():
            continue
        try:
            json.loads((ckpt_dir / f"{p.name}.meta.json").read_text())
        except (OSError, ValueError):
            continue
        steps.append(int(suffix))
    return max(steps) if steps else None


def diagnose(run_dir: Path | str, since: float = 0.0) -> dict:
    """`cli doctor`'s classification over the run dir's evidence,
    restricted to records from the current attempt (`since`, an epoch
    time): a prior attempt's torn intent or stale heartbeat must not
    pollute the verdict for THIS death."""
    run_dir = Path(run_dir)
    flight = [
        r
        for r in read_flight(run_dir / FLIGHT_FILENAME)
        if float(r.get("time") or 0.0) >= since
    ]
    health = None
    try:
        payload = json.loads((run_dir / "health.json").read_text())
        if (
            isinstance(payload, dict)
            and float(payload.get("time") or 0.0) >= since
        ):
            health = payload
    except (OSError, ValueError):
        pass
    ledger = resolve_ledger_path(run_dir)
    utils = [
        r
        for r in (read_ledger(ledger, kinds={"util"}) if ledger else [])
        if float(r.get("time") or 0.0) >= since
    ]
    wedge = read_wedge_report(run_dir / WEDGE_REPORT_FILENAME)
    if wedge is not None and float(wedge.get("time") or 0.0) < since:
        wedge = None
    preempt = read_preempt_report(run_dir / PREEMPT_REPORT_FILENAME)
    if preempt is not None and float(preempt.get("time") or 0.0) < since:
        preempt = None
    return classify_run(
        flight, health=health, utils=utils, wedge=wedge, preempt=preempt
    )


class Supervisor:
    """The spawn / classify / recover loop around one child command.
    `popen`, `sleep` and `now` are injectable (tests script a child and
    freeze the clock); by default `subprocess.Popen`, `time.sleep` and
    `time.time`."""

    def __init__(
        self,
        child_argv: list[str],
        run_dir: Path | str,
        policy: "RecoveryPolicy | None" = None,
        *,
        popen=subprocess.Popen,
        sleep=time.sleep,
        now=time.time,
    ) -> None:
        self.child_argv = list(child_argv)
        self.run_dir = Path(run_dir)
        self.policy = policy or RecoveryPolicy()
        self._popen = popen
        self._sleep = sleep
        self._now = now
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._ledger = MetricsLedger(self.run_dir / SUPERVISOR_FILENAME)
        self.trace_ctx = tracectx.mint(parent=tracectx.from_env())
        self._attempt_ctx: "tracectx.TraceContext | None" = None
        self._child = None
        self._terminating = False

    def _event(self, event: str, **fields) -> None:
        ctx = self._attempt_ctx or self.trace_ctx
        self._ledger.append(
            {
                "kind": "supervisor",
                "event": event,
                "time": self._now(),
                "pid": os.getpid(),
                **ctx.fields(),
                **fields,
            }
        )

    def _forward_signal(self, signum, frame) -> None:
        self._terminating = True
        child = self._child
        self._event("forward-signal", signum=int(signum))
        if child is not None and child.poll() is None:
            try:
                child.send_signal(signum)
            except OSError:
                pass

    def _archive_attempt_reports(self, attempt: int) -> None:
        """Move the one-shot report files aside so the next attempt's
        diagnosis can't read this attempt's death certificate."""
        for name in (WEDGE_REPORT_FILENAME, PREEMPT_REPORT_FILENAME, WEDGE_STACKS_FILENAME):
            path = self.run_dir / name
            if path.exists():
                try:
                    os.replace(path, self.run_dir / f"{name}.attempt{attempt}")
                except OSError:
                    pass

    def run(self) -> int:
        """Supervise until the child completes (0), the policy gives up
        (115), or a forwarded SIGTERM / SIGINT ends the run (the child's
        own exit code, normally 114)."""
        overrides: dict = {}
        installed = threading.current_thread() is threading.main_thread()
        prev_handlers = {}
        if installed:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, self._forward_signal)
        attempt = 0
        try:
            while True:
                attempt += 1
                self._attempt_ctx = self.trace_ctx.child()
                env = tracectx.child_env(self._attempt_ctx)
                if overrides:
                    env[OVERRIDES_ENV] = json.dumps(overrides)
                spawn_t = self._now()
                self._event("spawn", attempt=attempt, argv=self.child_argv, overrides=overrides)
                self._child = self._popen(self.child_argv, env=env)
                rc = self._child.wait()
                self._child = None
                if self._terminating:
                    self._event("terminated", attempt=attempt, rc=rc)
                    return rc if rc else PREEMPT_EXIT_CODE
                if rc == 0:
                    self._event("complete", attempt=attempt)
                    return 0
                verdict = diagnose(self.run_dir, since=spawn_t)
                progress = latest_committed_step(self.run_dir)
                action = self.policy.decide(
                    verdict=verdict["verdict"],
                    exit_code=rc,
                    family=verdict.get("family"),
                    progress_step=progress,
                )
                self._event(
                    "death",
                    attempt=attempt,
                    rc=rc,
                    verdict=verdict["verdict"],
                    program=verdict.get("program"),
                    family=verdict.get("family"),
                    detail=verdict.get("detail"),
                    progress_step=progress,
                    action=action.kind,
                    delay_s=action.delay_s,
                    overrides=action.overrides,
                    reason=action.reason,
                )
                logger.warning(
                    "child died (rc=%d, verdict=%s, progress=%s) -> %s: %s",
                    rc, verdict["verdict"], progress, action.kind, action.reason,
                )
                if action.kind != "restart":
                    self._event("give-up", reason=action.reason)
                    return SUPERVISOR_GIVEUP_EXIT_CODE
                self._archive_attempt_reports(attempt)
                overrides = action.overrides
                if action.delay_s > 0:
                    self._sleep(action.delay_s)
        finally:
            if installed:
                for sig, handler in prev_handlers.items():
                    signal.signal(sig, handler)
