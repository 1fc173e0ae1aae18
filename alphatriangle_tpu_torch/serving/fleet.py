"""Serve-fleet control plane: counterpart of `alphatriangle_tpu/serving/
fleet.py`, writing the same `fleet.jsonl`.

The parent process behind `cli fleet`, which imports neither torch nor
numpy: it spawns N `python -m alphatriangle_tpu_torch.serving.replica`
subprocesses (each a `PolicyService` on the card, with its own CUDA
context, run directory, heartbeat, flight ring and metrics ledger),
keeps a `ReplicaRouter`'s admission view fresh through the shared
`telemetry.health.probe_run` probe, and supervises each replica:

- a death is classified by `supervise.supervisor.diagnose` over the
  replica's own run directory, on the evidence since its spawn (a
  SIGKILL reads clean, a `hang-serve` wedge reads dispatch-hung naming
  `serve/b<B>`);
- `supervise.policy.RecoveryPolicy` maps the verdict to a restart after
  a backoff under a restart budget; the serve quarantine's
  `SERVE_SLOTS__scale` is read here, respawning the replica onto the
  ladder's lower rung;
- the replica's served-move count is the progress that resets the
  backoff streak.

Every lifecycle and routing decision is appended crash-safely to
`fleet.jsonl` through `MetricsLedger`: the death -> verdict -> respawn
-> re-admission chain is read back from it. The parent also writes
`kind:"util"` ticks to its own metrics.jsonl for the SLO engine.
"""

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

from ..supervise.policy import RecoveryPolicy
from ..supervise.supervisor import diagnose
from ..telemetry import tracectx
from ..telemetry.flight import (
    DOCTOR_EXIT_CODES,
    FLIGHT_FILENAME,
    FlightRecorder,
    read_flight,
    unsealed_intents,
)
from ..telemetry.health import PROBE_LIVE, probe_run
from ..telemetry.ledger import MetricsLedger, iter_jsonl_records, ledger_paths
from .router import ReplicaError, ReplicaRouter

logger = logging.getLogger(__name__)

FLEET_FILENAME = "fleet.jsonl"


class _Pending:
    """Minimal future for one in-flight replica request."""

    __slots__ = ("rid", "_handle", "_ev", "value", "error", "cancelled")

    def __init__(self, rid: int, handle=None):
        self.rid = rid
        self._handle = handle
        self._ev = threading.Event()
        self.value: "dict | None" = None
        self.error: "Exception | None" = None
        self.cancelled = False

    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: "float | None" = None) -> bool:
        return self._ev.wait(timeout)

    def resolve(self, value: dict) -> None:
        self.value = value
        self._ev.set()

    def fail(self, error: Exception) -> None:
        if not self._ev.is_set():
            self.error = error
            self._ev.set()

    def cancel(self) -> None:
        """Cancel-on-first-win: drop the request from its handle's
        queue-depth accounting and resolve the waiter; the replica may
        still answer (idempotent episodes), the reply is ignored."""
        self.cancelled = True
        if self._handle is not None:
            self._handle._discard(self.rid)
        self.fail(ReplicaError("cancelled"))


class ProcessReplicaHandle:
    """Persistent identity for one replica slot across incarnations.

    Satisfies the router's handle protocol (`name`/`routable`/
    `queue_depth`/`bucket`/`submit`). `attach` binds a fresh
    subprocess (spawn or respawn); a reader thread resolves pending
    futures from stdout and fails them all on EOF so a SIGKILLed
    replica turns into immediate retries instead of timeouts."""

    def __init__(self, name: str, run_dir: Path):
        self.name = name
        self.run_dir = Path(run_dir)
        self.proc = None
        self.generation = 0
        self.bucket: "int | None" = None
        # Inference precision self-reported on the ready line (None
        # until ready, and for legacy replicas that don't report it).
        self.precision: "str | None" = None
        self.admit = True  # rolling-reload drain gate
        self.probe_ok = False
        self.ready = threading.Event()
        self.ready_info: "dict | None" = None
        # Fired (handle, ready_msg) when an incarnation's ready line
        # lands — the fleet supervisor ledgers the replica's
        # (monotonic, wall) clock pair for trace merge calibration.
        self.on_ready = None
        self.served_moves = 0  # progress signal for the recovery policy
        self.episodes_ok = 0
        self._lock = threading.Lock()
        self._pending: dict[int, _Pending] = {}
        self._rid = 0

    # --- router protocol -------------------------------------------------

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    @property
    def routable(self) -> bool:
        return (
            self.alive and self.admit and self.probe_ok and self.ready.is_set()
        )

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def submit(self, payload: dict) -> _Pending:
        with self._lock:
            proc = self.proc
            if proc is None or proc.poll() is not None:
                raise ReplicaError(f"replica {self.name} is not running")
            self._rid += 1
            pending = _Pending(self._rid, self)
            self._pending[self._rid] = pending
            line = json.dumps({**payload, "id": self._rid}) + "\n"
            try:
                proc.stdin.write(line)
                proc.stdin.flush()
            except Exception as exc:
                del self._pending[self._rid]
                raise ReplicaError(
                    f"replica {self.name} pipe write failed: {exc}"
                ) from exc
        return pending

    def request(self, payload: dict, timeout_s: float = 30.0) -> dict:
        """Synchronous control-plane request (ping/stats/reload)."""
        pending = self.submit(payload)
        if not pending.wait(timeout_s):
            pending.cancel()
            raise ReplicaError(
                f"replica {self.name} {payload.get('kind')} timed out "
                f"after {timeout_s:g}s"
            )
        if pending.error is not None:
            raise pending.error
        return pending.value or {}

    # --- incarnation lifecycle -------------------------------------------

    def attach(self, proc, bucket: int) -> None:
        self.proc = proc
        self.bucket = bucket
        self.generation += 1
        self.ready.clear()
        self.ready_info = None
        self.probe_ok = False
        reader = threading.Thread(
            target=self._read_loop,
            args=(proc,),
            name=f"fleet-read-{self.name}",
            daemon=True,
        )
        reader.start()

    def _read_loop(self, proc) -> None:
        try:
            for line in proc.stdout:
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    logger.warning(
                        "%s: unparseable reply line %r", self.name, line[:200]
                    )
                    continue
                if msg.get("kind") == "ready" and "id" not in msg:
                    self.ready_info = msg
                    self.ready.set()
                    if self.on_ready is not None:
                        try:
                            self.on_ready(self, msg)
                        except Exception:
                            logger.exception(
                                "%s on_ready hook failed", self.name
                            )
                    continue
                with self._lock:
                    pending = self._pending.pop(msg.get("id"), None)
                if pending is None:
                    continue  # cancelled (hedge loser) or stale
                if msg.get("ok"):
                    if msg.get("kind") == "episode":
                        self.served_moves += int(msg.get("moves") or 0)
                        self.episodes_ok += 1
                    pending.resolve(msg)
                else:
                    pending.fail(
                        ReplicaError(
                            f"{self.name}: {msg.get('error') or 'replica error'}"
                        )
                    )
        except Exception:
            logger.exception("%s reader failed", self.name)
        finally:
            # EOF: only fail pendings if this is still the live
            # incarnation (a respawn may already have replaced us).
            if self.proc is proc:
                self.fail_all(ReplicaError(f"replica {self.name} died"))

    def fail_all(self, error: Exception) -> None:
        with self._lock:
            pending, self._pending = dict(self._pending), {}
        for p in pending.values():
            p.fail(error)

    def _discard(self, rid: int) -> None:
        with self._lock:
            self._pending.pop(rid, None)


class FleetSupervisor:
    """Spawn/probe/classify/respawn loop around N serve replicas.

    `popen`/`now`/`sleep` are injectable, so tests script replica
    deaths without processes; `policy_factory` builds one
    RecoveryPolicy PER replica so each has its own backoff streak and
    restart budget. `replica_extra_argv` reaches every replica's argv
    (`cli fleet` passes `--device` and `--state-dict` this way)."""

    def __init__(
        self,
        run_dir: "Path | str",
        *,
        replicas: int = 2,
        slots: int = 8,
        sims: int = 4,
        ladder=None,
        seed: int = 0,
        configs_dir: "Path | str | None" = None,
        replica_extra_argv: "list | None" = None,
        policy_factory=None,
        probe_deadline_s: float = 10.0,
        poll_s: float = 0.25,
        spawn_timeout_s: float = 300.0,
        popen=subprocess.Popen,
        now=time.time,
        sleep=time.sleep,
    ) -> None:
        from .buckets import BucketLadder

        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.slots = slots
        # The serve-shape ladder quarantine walks replicas down
        # (serving/buckets.py — the same rung set the micro-batcher
        # uses; None = the implicit halving ladder under `slots`).
        self.ladder = BucketLadder.from_spec(ladder, base=slots)
        self.sims = sims
        self.seed = seed
        self.configs_dir = str(configs_dir) if configs_dir else ""
        self.replica_extra_argv = list(replica_extra_argv or [])
        self.probe_deadline_s = probe_deadline_s
        self.poll_s = poll_s
        self.spawn_timeout_s = spawn_timeout_s
        self._popen = popen
        self._now = now
        self._sleep = sleep
        policy_factory = policy_factory or RecoveryPolicy
        self._ledger = MetricsLedger(self.run_dir / FLEET_FILENAME)
        self._metrics = MetricsLedger(self.run_dir / "metrics.jsonl")
        # The fleet's own flight ring: routed requests bracket as
        # `fleet/route` so a dead parent names its in-flight requests.
        self.flight = FlightRecorder(self.run_dir / "flight.jsonl")
        self.handles = [
            ProcessReplicaHandle(f"r{i}", self.run_dir / f"replica_r{i}")
            for i in range(replicas)
        ]
        for h in self.handles:
            h.on_ready = self._on_replica_ready
        # Fleet-lifetime root trace (telemetry/tracectx.py); each
        # replica incarnation spawns under a child of it, handed to the
        # replica process via the traceparent env seam so its own
        # telemetry links back to the spawn event.
        self.trace_ctx = tracectx.mint(parent=tracectx.from_env())
        self._spawn_ctx: dict[str, tracectx.TraceContext] = {}
        self._policies = {h.name: policy_factory() for h in self.handles}
        self._spawn_t: dict[str, float] = {}
        self._attempts: dict[str, int] = {h.name: 0 for h in self.handles}
        self._overrides: dict[str, dict] = {h.name: {} for h in self.handles}
        self._restart_at: dict[str, float] = {}
        self.gaveup: set = set()
        self.deaths = 0
        self.respawns = 0
        self.evictions = 0
        self.readmissions = 0
        self.reload_rounds = 0
        self.reload_recompiles = 0
        self._stop = threading.Event()
        self._monitor: "threading.Thread | None" = None

    # --- ledger -----------------------------------------------------------

    def _event(self, event: str, **fields) -> None:
        self._ledger.append(
            {
                "kind": "fleet",
                "event": event,
                "time": self._now(),
                "pid": os.getpid(),
                **fields,
            }
        )

    def util_tick(
        self, step: int, moves: int, requests: int, window_s: float
    ) -> None:
        """One `kind:"util"` record on the fleet parent's metrics
        ledger: the served volume the availability SLO integrates."""
        dt = max(1e-9, window_s)
        self._metrics.append(
            {
                "kind": "util",
                "time": self._now(),
                "step": step,
                "window_s": round(window_s, 3),
                "moves_per_sec": round(moves / dt, 3),
                "serve_requests_per_sec": round(requests / dt, 3),
            }
        )

    def router_event(self, fields: dict) -> None:
        """ReplicaRouter.on_event sink: shed/retry/hedge/exhausted
        decisions land beside the lifecycle events."""
        fields = dict(fields)
        # The router annotates sheds with the REQUEST's kind
        # ("episode"); rename it or it would override the ledger's
        # `kind: "fleet"` and hide the event from summarize_fleet.
        if "kind" in fields:
            fields["request_kind"] = fields.pop("kind")
        self._event(fields.pop("event", "route"), **fields)

    def build_router(self, **router_kw) -> ReplicaRouter:
        router_kw.setdefault("flight", self.flight)
        router_kw.setdefault("on_event", self.router_event)
        return ReplicaRouter(self.handles, **router_kw)

    # --- spawning ---------------------------------------------------------

    def _effective_slots(self, name: str) -> int:
        """The `serve/b<B>` rung this replica's next incarnation
        serves at: the base width scaled by any quarantine multiplier
        (supervise/policy.py `SERVE_SLOTS__scale`), then snapped DOWN
        onto the bucket ladder — quarantine is a forced walk-down on
        the same ladder the micro-batcher climbs, so a degraded
        replica always lands on a rung it warms."""
        scale = float(
            self._overrides.get(name, {}).get("SERVE_SLOTS__scale", 1.0)
        )
        return self.ladder.rung_at_or_below(
            max(1.0, round(self.slots * scale))
        )

    def _spawn(self, handle: ProcessReplicaHandle, event: str) -> None:
        self._attempts[handle.name] += 1
        attempt = self._attempts[handle.name]
        bucket = self._effective_slots(handle.name)
        handle.run_dir.mkdir(parents=True, exist_ok=True)
        argv = [
            sys.executable,
            "-m",
            "alphatriangle_tpu_torch.serving.replica",
            "--run-dir",
            str(handle.run_dir),
            "--configs-dir",
            self.configs_dir,
            "--name",
            handle.name,
            "--slots",
            str(bucket),
            "--sims",
            str(self.sims),
            "--seed",
            str(self.seed + int(handle.name[1:] or 0)),
            *self.replica_extra_argv,
        ]
        stderr_log = open(  # noqa: SIM115 — lives as long as the child
            handle.run_dir / "replica.stderr.log", "ab"
        )
        # Each incarnation gets a child trace context, handed down via
        # the env seam (the replica's RunTelemetry adopts it as the
        # base trace on its flight ring) and stamped on the spawn and
        # death events so one trace_id follows the incarnation.
        ctx = self.trace_ctx.child()
        self._spawn_ctx[handle.name] = ctx
        proc = self._popen(
            argv,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=stderr_log,
            text=True,
            env=tracectx.child_env(ctx),
        )
        stderr_log.close()
        self._spawn_t[handle.name] = self._now()
        handle.attach(proc, bucket)
        self._event(
            event,
            replica=handle.name,
            pid=proc.pid,
            slots=bucket,
            attempt=attempt,
            overrides=self._overrides.get(handle.name) or {},
            **ctx.fields(),
        )

    def _on_replica_ready(self, handle: ProcessReplicaHandle, msg: dict) -> None:
        """Ledger a replica's ready line, with its `(t_mono, time)`
        clock pair: the sample a fleet trace merge places that
        process's monotonic timestamps on the shared wall clock by."""
        ctx = self._spawn_ctx.get(handle.name)
        # The replica self-reports its rung, inference precision and
        # device (every reader treats the fields as optional).
        handle.precision = msg.get("precision")
        self._event(
            "replica-ready",
            replica=handle.name,
            generation=handle.generation,
            replica_pid=msg.get("pid"),
            slots=msg.get("slots"),
            precision=msg.get("precision"),
            warm_aot=msg.get("warm_aot"),
            device=msg.get("device"),
            t_mono=msg.get("t_mono"),
            replica_time=msg.get("time"),
            **(ctx.fields() if ctx is not None else {}),
        )

    def start(self, wait_ready: bool = True) -> None:
        self._event(
            "fleet-start",
            replicas=len(self.handles),
            slots=self.slots,
            rungs=list(self.ladder.rungs),
            sims=self.sims,
        )
        for h in self.handles:
            self._spawn(h, "spawn")
        if wait_ready:
            deadline = time.monotonic() + self.spawn_timeout_s
            for h in self.handles:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not h.ready.wait(remaining):
                    raise RuntimeError(
                        f"replica {h.name} not ready within "
                        f"{self.spawn_timeout_s:g}s (see "
                        f"{h.run_dir / 'replica.stderr.log'})"
                    )
            for h in self.handles:
                self._probe(h)
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="fleet-monitor", daemon=True
        )
        self._monitor.start()

    # --- monitoring -------------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:
                logger.exception("fleet monitor iteration failed")

    def poll_once(self) -> None:
        now = self._now()
        for h in self.handles:
            if h.name in self.gaveup:
                continue
            if h.name in self._restart_at:
                if now >= self._restart_at[h.name]:
                    del self._restart_at[h.name]
                    self.respawns += 1
                    self._spawn(h, "respawn")
                continue
            if h.proc is not None and h.proc.poll() is not None:
                self._on_death(h)
                continue
            if h.alive and h.ready.is_set():
                self._probe(h)

    def _on_death(self, handle: ProcessReplicaHandle) -> None:
        rc = handle.proc.returncode
        handle.fail_all(
            ReplicaError(f"replica {handle.name} died (rc={rc})")
        )
        handle.probe_ok = False
        verdict = diagnose(
            handle.run_dir, since=self._spawn_t.get(handle.name, 0.0)
        )
        policy = self._policies[handle.name]
        action = policy.decide(
            verdict=verdict["verdict"],
            exit_code=rc if rc is not None else -1,
            family=verdict.get("family"),
            progress_step=handle.served_moves,
        )
        self.deaths += 1
        ctx = self._spawn_ctx.get(handle.name)
        self._event(
            "death",
            replica=handle.name,
            rc=rc,
            generation=handle.generation,
            verdict=verdict["verdict"],
            program=verdict.get("program"),
            family=verdict.get("family"),
            progress_moves=handle.served_moves,
            action=action.kind,
            delay_s=action.delay_s,
            overrides=action.overrides,
            reason=action.reason,
            **(ctx.fields() if ctx is not None else {}),
        )
        logger.warning(
            "replica %s died (rc=%s, verdict=%s) -> %s: %s",
            handle.name,
            rc,
            verdict["verdict"],
            action.kind,
            action.reason,
        )
        if action.kind != "restart":
            self.gaveup.add(handle.name)
            self._event("give-up", replica=handle.name, reason=action.reason)
            return
        self._overrides[handle.name] = dict(action.overrides)
        self._restart_at[handle.name] = self._now() + action.delay_s

    def _probe(self, handle: ProcessReplicaHandle) -> None:
        result = probe_run(
            handle.run_dir,
            now=self._now(),
            deadline_s=self.probe_deadline_s,
        )
        ok = result["code"] == PROBE_LIVE
        if ok and not handle.probe_ok:
            handle.probe_ok = True
            self.readmissions += 1
            self._event(
                "readmit",
                replica=handle.name,
                generation=handle.generation,
                slots=handle.bucket,
            )
        elif not ok and handle.probe_ok:
            handle.probe_ok = False
            self.evictions += 1
            self._event(
                "evict",
                replica=handle.name,
                code=result["code"],
                verdict=result["verdict"],
                reason=result["reason"],
            )

    # --- rolling weight swap ---------------------------------------------

    def rolling_reload(
        self,
        drain_timeout_s: float = 30.0,
        request_timeout_s: float = 120.0,
    ) -> dict:
        """Drain one replica at a time out of admission, hot-reload its
        weights, read its `recompiles` (kernel libraries built or
        loaded by the reload: 0) from the reply, re-admit. The rest of
        the fleet keeps serving throughout."""
        self._event("reload-start")
        reloaded, recompiles = 0, 0
        for h in self.handles:
            if not (h.alive and h.ready.is_set()):
                continue
            h.admit = False
            t0 = time.monotonic()
            while h.queue_depth > 0 and time.monotonic() - t0 < drain_timeout_s:
                self._sleep(0.05)
            try:
                reply = h.request(
                    {"kind": "reload"}, timeout_s=request_timeout_s
                )
                rec = int(reply.get("recompiles") or 0)
                reloaded += 1
                recompiles += rec
                self._event(
                    "replica-reloaded",
                    replica=h.name,
                    reloads=reply.get("reloads"),
                    recompiles=rec,
                    drained_s=round(time.monotonic() - t0, 3),
                )
            except Exception as exc:
                self._event(
                    "reload-failed", replica=h.name, error=str(exc)
                )
            finally:
                h.admit = True
        self.reload_rounds += 1
        self.reload_recompiles += recompiles
        self._event("reload-done", replicas=reloaded, recompiles=recompiles)
        return {"replicas": reloaded, "recompiles": recompiles}

    # --- chaos + shutdown --------------------------------------------------

    def kill_replica(self, name: "str | None" = None) -> "str | None":
        """SIGKILL one live replica (the storm's chaos hook). Returns
        the victim's name (None when nothing is killable)."""
        for h in self.handles:
            if (name is None or h.name == name) and h.alive:
                self._event("chaos-kill", replica=h.name, pid=h.proc.pid)
                try:
                    os.kill(h.proc.pid, signal.SIGKILL)
                except OSError:
                    return None
                return h.name
        return None

    def stop(self, timeout_s: float = 15.0) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        for h in self.handles:
            if not h.alive:
                continue
            try:
                h.request({"kind": "shutdown"}, timeout_s=timeout_s)
            except Exception:
                pass
            try:
                h.proc.stdin.close()
            except Exception:
                pass
            try:
                h.proc.wait(timeout=timeout_s)
            except Exception:
                try:
                    h.proc.kill()
                    h.proc.wait(timeout=5.0)
                except Exception:
                    pass
        self.flight.close()
        self._event(
            "fleet-stop",
            deaths=self.deaths,
            respawns=self.respawns,
            gaveup=sorted(self.gaveup),
        )

    def summary(self) -> dict:
        return {
            "replicas": len(self.handles),
            "deaths": self.deaths,
            "respawns": self.respawns,
            "evictions": self.evictions,
            "readmissions": self.readmissions,
            "gaveup": sorted(self.gaveup),
            "reload_rounds": self.reload_rounds,
            "reload_recompiles": self.reload_recompiles,
            "buckets": {h.name: h.bucket for h in self.handles},
            "precisions": {h.name: h.precision for h in self.handles},
            "rungs": list(self.ladder.rungs),
        }


def run_fleet_load(
    router: ReplicaRouter,
    fleet: "FleetSupervisor | None" = None,
    *,
    requests: int = 32,
    concurrency: int = 8,
    max_moves: int = 12,
    seed: int = 0,
    timeout_s: "float | None" = None,
    tick_every_s: float = 1.0,
    on_complete=None,
) -> dict:
    """The loadgen storm: `requests` episode requests pushed through
    the router from `concurrency` worker threads. `on_complete(n)`
    fires after the n-th terminal outcome (the smoke's chaos-kill and
    rolling-reload triggers). Returns the accounting the zero-lost
    invariant is asserted on."""
    from ..telemetry.perf import _percentile

    jobs: list[int] = list(range(requests))
    jobs.reverse()
    results: list = []
    lock = threading.Lock()
    moves_window = [0]
    t_start = time.monotonic()
    last_tick = [t_start]
    last_n = [0]  # terminal outcomes already reported in a prior tick

    def worker() -> None:
        while True:
            with lock:
                if not jobs:
                    return
                i = jobs.pop()
            res = router.route(
                {"kind": "episode", "seed": seed + i, "max_moves": max_moves},
                timeout_s=timeout_s,
            )
            with lock:
                results.append(res)
                n = len(results)
                if res.ok and res.value:
                    moves_window[0] += int(res.value.get("moves") or 0)
                now = time.monotonic()
                tick_due = (
                    fleet is not None
                    and now - last_tick[0] >= tick_every_s
                )
                if tick_due:
                    window = now - last_tick[0]
                    moves, moves_window[0] = moves_window[0], 0
                    # Windowed, not cumulative: the SLO engine
                    # (telemetry/slo.py) integrates rate * window_s per
                    # tick, so each request must be counted once.
                    win_requests = n - last_n[0]
                    last_n[0] = n
                    last_tick[0] = now
            if tick_due:
                fleet.util_tick(
                    step=n,
                    moves=moves,
                    requests=win_requests,
                    window_s=window,
                )
            if on_complete is not None:
                try:
                    on_complete(n)
                except Exception:
                    logger.exception("storm on_complete hook failed")

    threads = [
        threading.Thread(target=worker, name=f"storm-{i}", daemon=True)
        for i in range(concurrency)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = max(1e-9, time.monotonic() - t_start)
    if fleet is not None:
        # Final tick covers only the tail window since the last mid-
        # storm tick (same once-per-request accounting as above).
        fleet.util_tick(
            step=len(results),
            moves=moves_window[0],
            requests=len(results) - last_n[0],
            window_s=max(1e-9, time.monotonic() - last_tick[0]),
        )

    completed = [r for r in results if r.ok]
    shed = [r for r in results if not r.ok and r.rejection is not None]
    lost = len(results) - len(completed) - len(shed)
    lat_ms = [
        float(v)
        for r in completed
        if r.value
        for v in (r.value.get("lat_ms") or [])
    ]
    request_s = [r.wait_s for r in completed]
    summary = {
        "requests": requests,
        "terminal": len(results),
        "completed": len(completed),
        "shed": len(shed),
        "shed_by_code": {
            code: sum(1 for r in shed if r.rejection == code)
            for code in sorted({r.rejection for r in shed})
        },
        "lost": lost,
        "retried_requests": sum(1 for r in results if r.attempts > 1),
        "hedged_requests": sum(1 for r in results if r.hedged),
        "moves": sum(
            int(r.value.get("moves") or 0)
            for r in completed
            if r.value
        ),
        "elapsed_s": round(elapsed, 3),
        "requests_per_sec": round(len(completed) / elapsed, 3),
        "move_latency_ms_p50": _percentile(lat_ms, 0.50),
        "move_latency_ms_p95": _percentile(lat_ms, 0.95),
        "request_s_p95": _percentile(request_s, 0.95),
        "router": router.stats.as_dict(),
    }
    if fleet is not None:
        fleet._event("storm-summary", **summary)
    return summary


# --- postmortem readers (stdlib only) ----------------------------------------


def read_fleet_events(run_dir: "Path | str") -> list[dict]:
    """All parseable `kind:"fleet"` events across ledger rotations,
    oldest first — the same tolerant-reader contract as read_flight
    (torn tails and legacy id-less records parse fine)."""
    out: list[dict] = []
    for p in ledger_paths(Path(run_dir) / FLEET_FILENAME):
        out.extend(iter_jsonl_records(p, kinds={"fleet"}))
    return out


def classify_fleet(run_dir: "Path | str") -> dict:
    """Postmortem classifier for a FLEET-PARENT run dir (the JAX `cli
    doctor` branch for dirs holding a fleet.jsonl — a fleet parent has
    no learner heartbeat, so `classify_run` would misread it as
    never-started).

    Verdicts reuse the DOCTOR_EXIT_CODES vocabulary, strongest
    evidence first:

    - `dispatch-hung`: the parent died holding routed requests — an
      unsealed `fleet/route` intent in the parent's own flight ring
      with no `fleet-stop` event.
    - a replica verdict: the parent died mid-run (no `fleet-stop`)
      right after a replica death, or gave a replica up — the fleet's
      verdict is that replica's ledgered death verdict (SIGKILL-style
      clean crash-loops surface as `host-stall` with the loop named).
    - `host-stall`: the parent died between routed requests (no
      `fleet-stop`, no death to blame).
    - `never-started`: a fleet.jsonl exists but holds no events.
    - `clean`: `fleet-stop` was written — the fleet ran to completion;
      deaths/respawns along the way were healed (the self-healing
      contract) and ride in the evidence.

    Returns the classify_run result shape:
    {verdict, exit_code, program, family, detail, evidence}.
    """
    run_dir = Path(run_dir)
    events = read_fleet_events(run_dir)
    by_event: dict[str, list[dict]] = {}
    for e in events:
        by_event.setdefault(str(e.get("event")), []).append(e)
    deaths = by_event.get("death", [])
    gaveup = sorted(
        {str(e.get("replica")) for e in by_event.get("give-up", [])}
    )
    stopped = bool(by_event.get("fleet-stop"))
    torn_route = [
        r
        for r in unsealed_intents(read_flight(run_dir / FLIGHT_FILENAME))
        if r.get("family") == "fleet"
    ]
    evidence = {
        "fleet_events": len(events),
        "deaths": len(deaths),
        "respawns": len(by_event.get("respawn", [])),
        "evictions": len(by_event.get("evict", [])),
        "gaveup": gaveup,
        "fleet_stop": stopped,
        "storm_summary": bool(by_event.get("storm-summary")),
        "unsealed_route_intents": len(torn_route),
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

    def replica_verdict(death: dict, why: str) -> dict:
        verdict = str(death.get("verdict"))
        replica = death.get("replica")
        if verdict in DOCTOR_EXIT_CODES and verdict not in (
            "clean",
            "never-started",
        ):
            return result(
                verdict,
                program=death.get("program"),
                family=death.get("family"),
                detail=f"{why}: replica {replica} died with verdict "
                f"{verdict} (rc={death.get('rc')})",
            )
        return result(
            "host-stall",
            detail=f"{why}: replica {replica} crash-looped "
            f"(last death rc={death.get('rc')}, verdict "
            f"{verdict or 'unknown'})",
        )

    if not events:
        return result(
            "never-started",
            detail="fleet.jsonl exists but holds no events: the parent "
            "died before spawning its first replica",
        )
    if torn_route and not stopped:
        intent = torn_route[-1]
        return result(
            "dispatch-hung",
            program=str(intent.get("program")),
            family="fleet",
            detail="fleet parent died holding "
            f"{len(torn_route)} routed request(s) in flight "
            f"(last seq {intent.get('seq')}, "
            f"trace {intent.get('trace_id') or 'untraced'})",
        )
    if not stopped:
        if deaths:
            return replica_verdict(
                deaths[-1], "fleet parent died mid-run (no fleet-stop)"
            )
        return result(
            "host-stall",
            detail="fleet parent died between routed requests: no "
            "fleet-stop event and no replica death to blame",
        )
    if gaveup:
        for death in reversed(deaths):
            if str(death.get("replica")) in gaveup:
                return replica_verdict(
                    death,
                    "fleet completed degraded (gave up on "
                    f"{', '.join(gaveup)})",
                )
        return result(
            "host-stall",
            detail="fleet completed degraded: gave up on "
            f"{', '.join(gaveup)} with no ledgered death verdict",
        )
    stop = by_event["fleet-stop"][-1]
    return result(
        "clean",
        detail="fleet ran to completion: "
        f"{stop.get('deaths', 0)} death(s), "
        f"{stop.get('respawns', 0)} respawn(s), all healed",
    )
