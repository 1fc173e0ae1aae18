"""Least-queue-depth replica router: counterpart of
`alphatriangle_tpu/serving/router.py`.

The routing half of the serve fleet, one `route()` call over a pool of
interchangeable replica handles:

- **health-gated admission**: only handles whose `routable` flag is up
  (fresh heartbeat probe, no unsealed flight intent past its deadline,
  kept by `fleet.FleetSupervisor`) get traffic; the least queue depth
  wins among them;
- **timeout and retry**: each attempt has `timeout_s`; a failed or timed
  out attempt retries after a capped exponential backoff onto another
  replica (a tried one only when no other is healthy);
- **hedging**: optionally, a straggling attempt launches a copy on a
  second replica after `hedge_after_s`; the first result wins and the
  other is cancelled (episode requests are idempotent);
- **load shedding**: admission is bounded (`max_inflight`); overflow and
  no-healthy-replica requests are rejected with distinct codes, so
  `completed + shed == requests` holds for every storm.

Stdlib only. Handles are duck-typed (`name`, `routable`, `queue_depth`,
`bucket`, `submit(payload) -> pending` with `done()/wait(t)/cancel()/
value/error`), and the clock and sleep are injectable, so tests drive
every edge case with fakes.
"""

import logging
import threading
import time
from dataclasses import dataclass, field

from ..telemetry import tracectx
from ..telemetry.flight import flight_span

logger = logging.getLogger(__name__)

#: Distinct rejection codes (the JAX package's). A shed
#: request was REFUSED before dispatch; an exhausted one failed every
#: allowed attempt and surfaces the last error.
REJECT_QUEUE_FULL = "queue-full"
REJECT_NO_HEALTHY = "no-healthy-replica"
REJECT_RETRIES_EXHAUSTED = "retries-exhausted"

#: Program name the router's flight bracket dispatches under (family
#: "fleet").
ROUTE_PROGRAM = "fleet/route"


class ReplicaError(RuntimeError):
    """A replica failed a request (died mid-flight, protocol error,
    or an in-replica exception surfaced in the reply)."""


@dataclass
class RouteResult:
    """Terminal outcome of one routed request: exactly one of
    `ok` (served), `rejection` set (shed/exhausted)."""

    ok: bool
    value: dict | None = None
    replica: str | None = None
    replica_bucket: int | None = None
    rejection: str | None = None
    error: Exception | None = None
    attempts: int = 0
    hedged: bool = False
    hedge_won: bool = False
    wait_s: float = 0.0
    trace_id: str | None = None


@dataclass
class RouterStats:
    requests: int = 0
    completed: int = 0
    shed_queue_full: int = 0
    shed_unhealthy: int = 0
    exhausted: int = 0
    retries: int = 0
    timeouts: int = 0
    hedges: int = 0
    hedge_wins: int = 0
    backoff_sleeps: list = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "requests": self.requests,
            "completed": self.completed,
            "shed_queue_full": self.shed_queue_full,
            "shed_unhealthy": self.shed_unhealthy,
            "exhausted": self.exhausted,
            "retries": self.retries,
            "timeouts": self.timeouts,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
        }


class ReplicaRouter:
    """Thread-safe router over a (mutable) list of replica handles.

    `clock`/`sleep` are injectable so tests freeze the backoff math;
    `poll_s` is the straggler-watch granularity while an attempt is in
    flight. `on_event` receives one dict per routing decision (shed /
    retry / hedge / exhausted) — the fleet supervisor ledgers them
    into fleet.jsonl; `flight` (optional FlightRecorder) brackets each
    routed request as `fleet/route` so a parent death names the
    requests it was holding."""

    def __init__(
        self,
        replicas: list,
        *,
        timeout_s: float = 30.0,
        retries: int = 2,
        backoff_base_s: float = 0.1,
        backoff_max_s: float = 2.0,
        hedge_after_s: "float | None" = None,
        max_inflight: int = 64,
        poll_s: float = 0.002,
        clock=time.monotonic,
        sleep=time.sleep,
        flight=None,
        on_event=None,
    ) -> None:
        self.replicas = replicas
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.hedge_after_s = hedge_after_s
        self.max_inflight = max_inflight
        self.poll_s = poll_s
        self._clock = clock
        self._sleep = sleep
        self.flight = flight
        self.on_event = on_event
        self.stats = RouterStats()
        self._lock = threading.Lock()
        self._inflight = 0

    # --- introspection ---------------------------------------------------

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def healthy(self) -> list:
        return [r for r in self.replicas if r.routable]

    def _emit(self, event: str, **fields) -> None:
        if self.on_event is None:
            return
        try:
            # Every decision carries the admission level so a tailer
            # (`cli watch`) can show queue pressure without polling.
            self.on_event(
                {"event": event, "inflight": self._inflight, **fields}
            )
        except Exception:
            logger.exception("router on_event hook failed for %r", event)

    def _pick(self, exclude: "tuple | list" = ()):
        """Healthiest target: least queue depth among routable replicas
        not yet tried this request; falls back to a tried replica when
        nothing else is routable (better than shedding), None when no
        replica is routable at all."""
        healthy = self.healthy()
        if not healthy:
            return None
        fresh = [r for r in healthy if r.name not in exclude]
        pool = fresh or healthy
        return min(pool, key=lambda r: (r.queue_depth, r.name))

    def backoff_delay(self, attempt: int) -> float:
        """Delay before retry `attempt` (1-based): base * 2^(k-1),
        capped — the same curve supervise.RecoveryPolicy uses."""
        return min(
            self.backoff_max_s, self.backoff_base_s * 2 ** (attempt - 1)
        )

    # --- the routed request ----------------------------------------------

    def route(self, payload: dict, timeout_s: "float | None" = None) -> RouteResult:
        """Route one request to a terminal outcome (never raises for
        replica-side failures — shed/exhausted outcomes carry their
        rejection code and last error instead).

        Every request is minted a trace context (telemetry/tracectx.py)
        — a child of any context already on the payload (a caller
        propagating its own trace), else a fresh root trace. The triple
        rides the payload to the replica, every router event, and the
        `fleet/route` flight bracket, so the merged fleet timeline can
        follow this exact request across the process boundary."""
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        ctx = tracectx.mint(parent=tracectx.TraceContext.from_fields(payload))
        trace = ctx.fields()
        payload = {**payload, **trace}
        with self._lock:
            self.stats.requests += 1
            if self._inflight >= self.max_inflight:
                self.stats.shed_queue_full += 1
                result = RouteResult(
                    ok=False,
                    rejection=REJECT_QUEUE_FULL,
                    trace_id=ctx.trace_id,
                )
                self._emit(
                    "shed",
                    rejection=REJECT_QUEUE_FULL,
                    kind=payload.get("kind"),
                    **trace,
                )
                return result
            self._inflight += 1
        t0 = self._clock()
        try:
            with flight_span(
                self.flight,
                "fleet",
                ROUTE_PROGRAM,
                avals=str(payload.get("kind", "request")),
                trace=trace,
            ):
                result = self._attempt_loop(payload, timeout_s, trace)
        finally:
            with self._lock:
                self._inflight -= 1
        result.wait_s = self._clock() - t0
        result.trace_id = ctx.trace_id
        if result.ok:
            with self._lock:
                self.stats.completed += 1
        return result

    def _attempt_loop(
        self, payload: dict, timeout_s: float, trace: "dict | None" = None
    ) -> RouteResult:
        tried: list = []
        trace = trace or {}
        last_error: "Exception | None" = None
        attempt = 0
        while attempt <= self.retries:
            target = self._pick(exclude=tried)
            if target is None:
                with self._lock:
                    self.stats.shed_unhealthy += 1
                self._emit(
                    "shed",
                    rejection=REJECT_NO_HEALTHY,
                    attempts=attempt,
                    error=str(last_error) if last_error else None,
                    kind=payload.get("kind"),
                    **trace,
                )
                return RouteResult(
                    ok=False,
                    rejection=REJECT_NO_HEALTHY,
                    attempts=attempt,
                    error=last_error,
                )
            if attempt > 0:
                delay = self.backoff_delay(attempt)
                with self._lock:
                    self.stats.retries += 1
                    self.stats.backoff_sleeps.append(delay)
                self._emit(
                    "retry",
                    replica=target.name,
                    attempt=attempt,
                    delay_s=delay,
                    error=str(last_error) if last_error else None,
                    **trace,
                )
                self._sleep(delay)
            tried.append(target.name)
            result = self._dispatch_one(
                target, payload, timeout_s, tried, trace
            )
            if result.ok:
                result.attempts = attempt + 1
                return result
            last_error = result.error
            attempt += 1
        with self._lock:
            self.stats.exhausted += 1
        self._emit(
            "exhausted",
            attempts=attempt,
            error=str(last_error) if last_error else None,
            kind=payload.get("kind"),
            **trace,
        )
        return RouteResult(
            ok=False,
            rejection=REJECT_RETRIES_EXHAUSTED,
            attempts=attempt,
            error=last_error,
        )

    def _dispatch_one(
        self,
        primary,
        payload: dict,
        timeout_s: float,
        tried: list,
        trace: "dict | None" = None,
    ) -> RouteResult:
        """One attempt on `primary`, optionally hedged onto a second
        replica after `hedge_after_s`. First finished copy wins; the
        loser is cancelled (cancel-on-first-win)."""
        deadline = self._clock() + timeout_s
        hedge_at = (
            None
            if self.hedge_after_s is None
            else self._clock() + self.hedge_after_s
        )
        try:
            pending = primary.submit(payload)
        except Exception as exc:  # dead pipe etc. — a failed attempt
            return RouteResult(ok=False, error=exc, replica=primary.name)
        hedge = None
        hedge_target = None
        while True:
            if pending is not None and pending.done():
                if hedge is not None:
                    hedge.cancel()
                if pending.error is None:
                    return RouteResult(
                        ok=True,
                        value=pending.value,
                        replica=primary.name,
                        replica_bucket=getattr(primary, "bucket", None),
                        hedged=hedge is not None,
                    )
                if hedge is None:
                    return RouteResult(
                        ok=False, error=pending.error, replica=primary.name
                    )
                # Primary failed but a hedge is still in flight: let it
                # race the remaining deadline before calling the
                # attempt failed.
                pending = None
            if hedge is not None and hedge.done():
                if pending is not None:
                    pending.cancel()
                if hedge.error is None:
                    with self._lock:
                        self.stats.hedge_wins += 1
                    self._emit(
                        "hedge-win",
                        replica=hedge_target.name,
                        primary=primary.name,
                        **(trace or {}),
                    )
                    return RouteResult(
                        ok=True,
                        value=hedge.value,
                        replica=hedge_target.name,
                        replica_bucket=getattr(hedge_target, "bucket", None),
                        hedged=True,
                        hedge_won=True,
                    )
                if pending is None:
                    return RouteResult(
                        ok=False, error=hedge.error, replica=hedge_target.name
                    )
                hedge = None  # hedge failed first; primary still racing
            now = self._clock()
            if now >= deadline:
                if pending is not None:
                    pending.cancel()
                if hedge is not None:
                    hedge.cancel()
                with self._lock:
                    self.stats.timeouts += 1
                return RouteResult(
                    ok=False,
                    error=TimeoutError(
                        f"request timed out after {timeout_s:g}s on "
                        f"{primary.name}"
                    ),
                    replica=primary.name,
                )
            if (
                hedge is None
                and hedge_at is not None
                and now >= hedge_at
                and pending is not None
            ):
                hedge_at = None  # at most one hedge per attempt
                hedge_target = self._pick(exclude=[*tried, primary.name])
                if hedge_target is not None and hedge_target is not primary:
                    try:
                        hedge = hedge_target.submit(payload)
                        with self._lock:
                            self.stats.hedges += 1
                        self._emit(
                            "hedge",
                            primary=primary.name,
                            backup=hedge_target.name,
                            **(trace or {}),
                        )
                    except Exception:
                        hedge = None
            self._sleep(self.poll_s)
