"""The port's `ReplicaRouter`, `RecoveryPolicy` and fault sites against
the JAX package's.

Each routing case of `tests/test_fleet.py::TestRouter` (shedding with
distinct codes, least queue depth, retry onto another replica, retry
exhaustion, capped backoff, hedge and cancel-on-first-win, timeouts)
runs through both routers on the same scripted fake handles and fake
clock: the `RouteResult`s, `RouterStats.as_dict()`, the event sequences
(trace ids aside, which are random), the backoff sleeps and the
cancellations must be equal. The recovery policy's decisions are
compared over sequences of deaths. No process is spawned.
"""

import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu.serving import router as jrouter  # noqa: E402
from alphatriangle_tpu.supervise import faults as jfaults  # noqa: E402
from alphatriangle_tpu.supervise import policy as jpolicy  # noqa: E402
from alphatriangle_tpu_torch.serving import router as trouter  # noqa: E402
from alphatriangle_tpu_torch.supervise import faults as tfaults  # noqa: E402
from alphatriangle_tpu_torch.supervise import policy as tpolicy  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)

TRACE_KEYS = {"trace_id", "span_id", "parent_id"}


class FakeClock:
    """A monotonic clock advanced only by `sleep`."""

    def __init__(self, t: float = 0.0):
        self.t = t
        self.sleeps: list[float] = []

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.sleeps.append(s)
        self.t += s


class FakePending:
    """A pre-resolved (or never-resolving) future."""

    def __init__(self, value=None, error=None, done=True):
        self.value = value
        self.error = error
        self._done = done
        self.cancelled = False

    def done(self) -> bool:
        return self._done

    def wait(self, timeout=None) -> bool:
        return self._done

    def cancel(self) -> None:
        self.cancelled = True
        if not self._done:
            self.error = RuntimeError("cancelled")
            self._done = True


class ClockPending(FakePending):
    """Resolves once the fake clock reaches `ready_at`."""

    def __init__(self, clock: FakeClock, ready_at: float, value=None):
        super().__init__(value=value, done=False)
        self._clock = clock
        self._ready_at = ready_at

    def done(self) -> bool:
        if not self._done and self._clock.t >= self._ready_at:
            self._done = True
        return self._done


class FakeReplica:
    """The router's handle protocol: each submit pops the next scripted
    outcome (a pending, or an exception submit raises)."""

    def __init__(self, name, *, routable=True, queue_depth=0, bucket=8, outcomes=None):
        self.name = name
        self.routable = routable
        self.queue_depth = queue_depth
        self.bucket = bucket
        self.outcomes = list(outcomes or [])
        self.scripted = list(self.outcomes)
        self.submits: list[dict] = []

    def submit(self, payload: dict):
        self.submits.append(payload)
        outcome = self.outcomes.pop(0) if self.outcomes else FakePending(value={"ok": True})
        if isinstance(outcome, Exception):
            raise outcome
        return outcome


def _unhealthy(clock):
    return [FakeReplica("r0", routable=False), FakeReplica("r1", routable=False)], {}


def _queue_full(clock):
    return [FakeReplica("r0")], {"max_inflight": 0}


def _least_depth(clock):
    return [FakeReplica("r0", queue_depth=3), FakeReplica("r1", queue_depth=1)], {}


def _retry_elsewhere(clock):
    return [
        FakeReplica("r0", outcomes=[FakePending(error=RuntimeError("r0 died"))]),
        FakeReplica("r1", queue_depth=5),
    ], {}


def _exhausted(clock):
    return [FakeReplica("r0", outcomes=[
        FakePending(error=RuntimeError(f"boom-{k}")) for k in (1, 2, 3)
    ])], {"retries": 2}


def _submit_raises(clock):
    return [
        FakeReplica("r0", outcomes=[RuntimeError("pipe closed")]),
        FakeReplica("r1", queue_depth=2, outcomes=[FakePending(error=RuntimeError("r1 bad"))]),
    ], {"retries": 3, "backoff_base_s": 0.5, "backoff_max_s": 0.8}


def _hedge_wins(clock):
    return [
        FakeReplica("r0", outcomes=[FakePending(done=False)]),
        FakeReplica("r1", queue_depth=9, outcomes=[FakePending(value={"ok": True, "kind": "episode"})]),
    ], {"hedge_after_s": 0.05}


def _primary_wins(clock):
    return [
        FakeReplica("r0", outcomes=[ClockPending(clock, 0.2, value={"ok": True})]),
        FakeReplica("r1", queue_depth=9, outcomes=[FakePending(done=False)]),
    ], {"hedge_after_s": 0.05}


def _hedge_fails_primary_wins(clock):
    return [
        FakeReplica("r0", outcomes=[ClockPending(clock, 0.3, value={"ok": True, "n": 1})]),
        FakeReplica("r1", queue_depth=9, outcomes=[FakePending(error=RuntimeError("hedge lost"))]),
    ], {"hedge_after_s": 0.05}


def _timeout(clock):
    return [FakeReplica("r0", outcomes=[FakePending(done=False)])], {"timeout_s": 0.1, "retries": 0}


CASES = {
    "all-unhealthy": _unhealthy,
    "queue-full": _queue_full,
    "least-queue-depth": _least_depth,
    "retry-elsewhere": _retry_elsewhere,
    "retries-exhausted": _exhausted,
    "submit-raises": _submit_raises,
    "hedge-wins": _hedge_wins,
    "primary-wins": _primary_wins,
    "hedge-fails-primary-wins": _hedge_fails_primary_wins,
    "timeout": _timeout,
}


def _route(router_mod, case: str, requests: int = 2):
    clock = FakeClock()
    replicas, kw = CASES[case](clock)
    events: list = []
    router = router_mod.ReplicaRouter(
        replicas, **{
            "timeout_s": 10.0, "retries": 2, "backoff_base_s": 0.1, "backoff_max_s": 2.0,
            "poll_s": 0.01, "clock": clock, "sleep": clock.sleep, "on_event": events.append, **kw,
        }
    )
    results = [router.route({"kind": "episode", "seed": i}) for i in range(requests)]
    outcome = {
        "results": [
            (r.ok, r.value, r.replica, r.replica_bucket, r.rejection, repr(r.error), r.attempts,
             r.hedged, r.hedge_won, round(r.wait_s, 9))
            for r in results
        ],
        "stats": router.stats.as_dict(),
        "backoff": router.stats.backoff_sleeps,
        "events": [{k: v for k, v in e.items() if k not in TRACE_KEYS} for e in events],
        "sleeps": clock.sleeps,
        "submits": [[{k: v for k, v in p.items() if k not in TRACE_KEYS} for p in r.submits]
                    for r in replicas],
        "cancelled": [[getattr(o, "cancelled", None) for o in r.scripted] for r in replicas],
        "inflight": router.inflight,
    }
    return outcome, results, events


@pytest.mark.parametrize("case", sorted(CASES))
def test_router_matches_jax(case):
    ours, results, events = _route(trouter, case)
    theirs, jresults, _ = _route(jrouter, case)
    assert ours == theirs
    assert ours["inflight"] == 0
    if case in ("hedge-wins", "primary-wins", "timeout"):
        assert True in sum(ours["cancelled"], [])  # cancel-on-first-win / on timeout
    # Every request was minted a trace of its own, carried by its events.
    assert len({r.trace_id for r in results}) == len(results)
    assert all(e["trace_id"] in {r.trace_id for r in results} for e in events)
    for r, j in zip(results, jresults, strict=True):
        assert (r.rejection is None) == r.ok and (j.rejection is None) == j.ok


def test_router_codes_and_backoff_curve():
    assert (trouter.REJECT_QUEUE_FULL, trouter.REJECT_NO_HEALTHY,
            trouter.REJECT_RETRIES_EXHAUSTED, trouter.ROUTE_PROGRAM) == (
        jrouter.REJECT_QUEUE_FULL, jrouter.REJECT_NO_HEALTHY,
        jrouter.REJECT_RETRIES_EXHAUSTED, jrouter.ROUTE_PROGRAM)
    router = trouter.ReplicaRouter([], backoff_base_s=0.5, backoff_max_s=1.7)
    assert [router.backoff_delay(k) for k in (1, 2, 3, 4)] == [0.5, 1.0, 1.7, 1.7]
    res = router.route({"kind": "episode"})
    assert not res.ok and res.rejection == trouter.REJECT_NO_HEALTHY


def test_route_brackets_in_the_flight_ring(tmp_path):
    from alphatriangle_tpu_torch.telemetry.flight import FlightRecorder, read_flight

    clock = FakeClock()
    flight = FlightRecorder(tmp_path / "flight.jsonl")
    router = trouter.ReplicaRouter([FakeReplica("r0")], clock=clock, sleep=clock.sleep,
                                   flight=flight)
    res = router.route({"kind": "episode", "seed": 3})
    records = read_flight(tmp_path / "flight.jsonl")
    assert [(r["phase"], r["program"], r["family"]) for r in records] == [
        ("intent", "fleet/route", "fleet"), ("seal", "fleet/route", "fleet")
    ]
    assert all(r["trace_id"] == res.trace_id for r in records)
    # A caller's trace is the parent of the routed request's.
    parent = {"trace_id": "ab" * 16, "span_id": "cd" * 8}
    res = router.route({"kind": "episode", **parent})
    assert res.trace_id == parent["trace_id"]


# --- the recovery policy -----------------------------------------------------

DEATHS = {
    "serve-wedge-quarantine": [("dispatch-hung", 113, "serve", 5), ("dispatch-hung", 113, "serve", 9),
                               ("clean", -9, None, 9), ("clean", -9, None, 9)],
    "crash-loop-breaker": [("clean", 1, None, None)] * 5,
    "budget": [("clean", -9, None, k) for k in range(12)],
    "oom-ladder": [("oom", 1, "learner", 3), ("oom", 1, "learner", 3), ("oom", 1, None, 4)],
    "preempted": [("preempted", 114, None, 2), ("clean", 1, None, 2), ("preempted", 114, None, 2)],
    "compile-hung-megastep": [("compile-hung", 113, "megastep", None)] * 3,
}


def _decide(policy_mod, deaths, **kw):
    policy = policy_mod.RecoveryPolicy(clock=lambda: 1000.0, **kw)
    out = []
    for verdict, rc, family, progress in deaths:
        a = policy.decide(verdict=verdict, exit_code=rc, family=family, progress_step=progress)
        out.append((a.kind, a.delay_s, a.overrides, a.reason))
    return out, policy.history, policy.streak


@pytest.mark.parametrize("quarantine_after", [1, 2])
@pytest.mark.parametrize("case", sorted(DEATHS))
def test_recovery_policy_matches_jax(case, quarantine_after):
    kw = dict(max_restarts=8, circuit_breaker_deaths=3, backoff_base_s=0.5, backoff_max_s=4.0,
              quarantine_after=quarantine_after)
    ours = _decide(tpolicy, DEATHS[case], **kw)
    assert ours == _decide(jpolicy, DEATHS[case], **kw)
    if case == "serve-wedge-quarantine":
        assert ours[0][quarantine_after - 1][2]["SERVE_SLOTS__scale"] == 0.5
    assert tpolicy.QUARANTINE_OVERRIDES == jpolicy.QUARANTINE_OVERRIDES
    assert tpolicy.WEDGE_VERDICTS == jpolicy.WEDGE_VERDICTS


# --- the fault sites -----------------------------------------------------------


def test_fault_sites_and_spec_match_jax():
    # The port arms the serve-dispatch site only, with the JAX faults.
    assert tfaults.SITE_FAULTS == {"serve-dispatch": jfaults.SITE_FAULTS["serve-dispatch"]}
    assert tfaults.SITE_FAULTS["serve-dispatch"] == ("hang-serve", "crash-serve")
    assert (tfaults.FAULTS_ENV, tfaults.FAULT_STATE_DIR_ENV) == (
        jfaults.FAULTS_ENV, jfaults.FAULT_STATE_DIR_ENV)
    for spec in ("hang-serve@after=6,crash-serve@after=2", " bad , x@y=z, sigterm@step=3", ""):
        assert tfaults.parse_spec(spec) == jfaults.parse_spec(spec)


def test_crash_serve_fires_once_per_state_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(tfaults.FAULTS_ENV, "crash-serve@after=2")
    monkeypatch.setenv(tfaults.FAULT_STATE_DIR_ENV, str(tmp_path))
    tfaults.fault_point("serve-dispatch", 1)  # below its threshold
    tfaults.fault_point("dispatch", 5)  # a site the port does not arm
    with pytest.raises(RuntimeError, match="injected serve-dispatch"):
        tfaults.fault_point("serve-dispatch", 2)
    tfaults.fault_point("serve-dispatch", 3)  # the sentinel is claimed
    assert (tmp_path / "crash-serve.fired").exists()
    # The JAX package's fault module honours the same sentinel.
    jfaults.fault_point("serve-dispatch", 4)


def test_unarmed_fault_site_is_a_no_op(monkeypatch):
    monkeypatch.delenv(tfaults.FAULTS_ENV, raising=False)
    tfaults.fault_point("serve-dispatch", 10**6)
