"""The port's telemetry planes against the JAX package's: the metrics
ledger, the flight ring, the heartbeat, the liveness probe, the
postmortem classifiers and the fleet SLO engine.

Each side reads the files the other wrote, and on the same evidence on
disk (written here record by record, with fixed times) both packages'
readers give the same verdicts, probes, SLO reports and Prometheus
text. Stdlib file formats only: nothing here runs a search.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu.serving import fleet as jfleet  # noqa: E402
from alphatriangle_tpu.supervise import supervisor as jsupervisor  # noqa: E402
from alphatriangle_tpu.telemetry import device_stats as jds  # noqa: E402
from alphatriangle_tpu.telemetry import flight as jflight  # noqa: E402
from alphatriangle_tpu.telemetry import health as jhealth  # noqa: E402
from alphatriangle_tpu.telemetry import ledger as jledger  # noqa: E402
from alphatriangle_tpu.telemetry import perf as jperf  # noqa: E402
from alphatriangle_tpu.telemetry import slo as jslo  # noqa: E402
from alphatriangle_tpu.utils import flops as jflops  # noqa: E402
from alphatriangle_tpu_torch.serving import fleet as tfleet  # noqa: E402
from alphatriangle_tpu_torch.supervise import supervisor as tsupervisor  # noqa: E402
from alphatriangle_tpu_torch.telemetry import device_stats as tds  # noqa: E402
from alphatriangle_tpu_torch.telemetry import flight as tflight  # noqa: E402
from alphatriangle_tpu_torch.telemetry import health as thealth  # noqa: E402
from alphatriangle_tpu_torch.telemetry import ledger as tledger  # noqa: E402
from alphatriangle_tpu_torch.telemetry import perf as tperf  # noqa: E402
from alphatriangle_tpu_torch.telemetry import slo as tslo  # noqa: E402
from alphatriangle_tpu_torch.utils import flops as tflops  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import torch_cfg  # noqa: E402

PACKAGES = {
    "jax": (jledger, jflight, jhealth),
    "torch": (tledger, tflight, thealth),
}
OTHER = {"jax": "torch", "torch": "jax"}
# Fields that carry this process's clocks or pid.
CLOCK_FIELDS = {"time", "t_mono", "pid", "wall_s", "expected_s", "monotonic", "uptime_s"}


def _strip(records: list) -> list:
    return [{k: v for k, v in r.items() if k not in CLOCK_FIELDS} for r in records]


def _write_jsonl(path, records, torn: str = "") -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(json.dumps(r) + "\n" for r in records) + torn)


# --- the metrics ledger ----------------------------------------------------


def test_ledger_append_torn_tail_and_rotation(tmp_path):
    path = tmp_path / "metrics.jsonl"
    path.write_text(json.dumps({"kind": "util", "step": 0}) + "\n" + '{"kind": "ut')
    led = tledger.MetricsLedger(path, max_bytes=200, keep=2)
    for step in range(1, 9):
        assert led.append({"kind": "util", "step": step, "pad": "x" * 40})
    files = tledger.ledger_paths(path)
    assert [p.name for p in files] == ["metrics.jsonl.2", "metrics.jsonl.1", "metrics.jsonl"]
    steps = [r["step"] for r in tledger.read_ledger(path)]
    assert steps == sorted(steps) and steps[-1] == 8
    # The torn tail of the earlier writer is a scar, never a lost record:
    # the first append of this writer started on a fresh line.
    assert all(p.read_text().endswith("\n") for p in files)
    assert tledger.read_ledger(path, kinds={"tick"}) == []
    assert jledger.read_ledger(path) == tledger.read_ledger(path)
    assert tledger.resolve_ledger_path(tmp_path) == path
    assert tledger.resolve_ledger_path(tmp_path / "absent") is None


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_ledgers_read_both_ways(tmp_path, writer):
    ledger_mod = PACKAGES[writer][0]
    path = tmp_path / "fleet.jsonl"
    led = ledger_mod.MetricsLedger(path, max_bytes=400, keep=3)
    records = [
        {"kind": "fleet", "event": "spawn", "replica": f"r{i}", "time": 100.0 + i}
        for i in range(12)
    ]
    for rec in records:
        led.append(rec)
    with path.open("a") as f:
        f.write('{"kind": "fleet", "eve')
    reader = PACKAGES[OTHER[writer]][0]
    assert reader.read_ledger(path) == records
    assert reader.read_ledger(path, kinds={"fleet"}) == records
    assert reader.read_ledger(path, kinds={"util"}) == []
    assert [p.name for p in reader.ledger_paths(path)] == [
        p.name for p in ledger_mod.ledger_paths(path)
    ]


def test_prometheus_textfile_matches_jax(tmp_path):
    record = {"moves_per_sec": 12.5, "serve_move_latency_ms_p95": 40.0, "serve_bucket": 16,
              "mfu": None, "stalled": True, "serve_fill": 0.75}
    jledger.write_prometheus_textfile(tmp_path / "j.prom", record, run_name="r")
    tledger.write_prometheus_textfile(tmp_path / "t.prom", record, run_name="r")
    assert (tmp_path / "t.prom").read_text() == (tmp_path / "j.prom").read_text()
    assert tledger.tick_record(3, {"a": 1.0}, now=5.0) == jledger.tick_record(3, {"a": 1.0}, now=5.0)


# --- the flight ring -------------------------------------------------------


def _drive_recorder(flight_mod, path):
    """Intent/seal traffic: two sealed dispatches, a failed one, a traced
    one and a last intent left unsealed."""
    rec = flight_mod.FlightRecorder(path, min_deadline_s=5.0, first_deadline_s=50.0)
    with flight_mod.flight_span(rec, "serve", "serve/b8", avals="b3"):
        pass
    with flight_mod.flight_span(rec, "serve", "serve/b8", avals="b2"):
        pass
    with pytest.raises(ValueError):
        with flight_mod.flight_span(rec, "serve", "serve/b4", avals="b1"):
            raise ValueError("boom")
    with flight_mod.flight_span(rec, "fleet", "fleet/route", avals="episode",
                                trace={"trace_ids": ["ab" * 16]}):
        pass
    rec.begin("serve", "serve/b8", avals="b8")
    return rec


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_flight_rings_read_both_ways(tmp_path, writer):
    _drive_recorder(PACKAGES[writer][1], tmp_path / "flight.jsonl")
    theirs = PACKAGES[OTHER[writer]][1].read_flight(tmp_path / "flight.jsonl")
    ours = PACKAGES[writer][1].read_flight(tmp_path / "flight.jsonl")
    assert theirs == ours and len(ours) == 9
    reader = PACKAGES[OTHER[writer]][1]
    torn = reader.unsealed_intents(theirs)
    assert [(r["program"], r["avals"]) for r in torn] == [("serve/b8", "b8")]
    assert tflight.classify_run(theirs) == jflight.classify_run(theirs)
    assert tflight.classify_run(theirs)["verdict"] == "dispatch-hung"


def test_flight_span_intent_seal_and_deadlines(tmp_path):
    """The port's recorder writes the JAX recorder's records, clocks
    aside: a first dispatch gets the first-dispatch allowance, a sealed
    one sets the program's expectation and the floored deadline, an error
    seals ok:false without teaching the expectation, trace fields ride
    both records."""
    jrec = _drive_recorder(jflight, tmp_path / "j.jsonl")
    trec = _drive_recorder(tflight, tmp_path / "t.jsonl")
    jrecords, trecords = (
        jflight.read_flight(tmp_path / "j.jsonl"), tflight.read_flight(tmp_path / "t.jsonl")
    )
    assert _strip(trecords) == _strip(jrecords)
    intents = [r for r in trecords if r["phase"] == "intent"]
    assert intents[0]["deadline_s"] == 50.0 and intents[0]["expected_s"] is None
    assert intents[1]["deadline_s"] == 5.0 and intents[1]["expected_s"] is not None
    failed = [r for r in trecords if r["phase"] == "seal" and not r["ok"]]
    assert [r["error"] for r in failed] == ["ValueError('boom')"]
    assert trec.expected_s("serve/b4") is None and trec.dispatches == jrec.dispatches == 3
    assert [r["trace_ids"] for r in trecords if "trace_ids" in r] == [["ab" * 16]] * 2
    assert tflight.program_family("serve/b16") == "serve"
    for name in ("fleet/route", "megastep/k2", "learner_step", "self_play_chunk/t8", "x/y"):
        assert tflight.program_family(name) == jflight.program_family(name)
    # A new recorder on the same ring inherits the sealed expectations
    # (from the walls on disk, which are rounded to the microsecond).
    again = tflight.FlightRecorder(tmp_path / "t.jsonl", min_deadline_s=5.0)
    assert again.expected_s("serve/b8") == pytest.approx(trec.expected_s("serve/b8"), abs=1e-6)
    assert again.expected_s("serve/b4") is None


class _Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def test_dispatch_watchdog_fires_once_without_exit(tmp_path):
    reports = {}
    for name, mod in (("jax", jflight), ("torch", tflight)):
        clock = _Clock(10.0)
        wedged = []
        run_dir = tmp_path / name
        # One beacon row in the run, each package's writer: the report
        # carries it as `last_beacon`.
        ds = {"jax": jds, "torch": tds}[name]
        ds.attach_beacon_run_dir(run_dir)
        ds.note_dispatch("serve/b16")
        if name == "jax":
            jds._write_beacon_row("search_wave", 8)
        else:
            tds.arm_beacons()
            tds.emit_beacon("search_wave", 8)
        dog = mod.DispatchWatchdog(run_dir, on_wedge=wedged.append, exit_on_wedge=False,
                                   clock=clock)
        dog.arm(3, program="serve/b16", family="serve", deadline_s=5.0, expected_s=0.4,
                avals="b16")
        dog.arm(4, program="serve/b16", family="serve", deadline_s=50.0)
        clock.t = 14.0
        assert dog.check() is None
        dog.disarm(4)
        clock.t = 16.5
        report = dog.check()
        assert report is not None and dog.wedge_count == 1
        assert dog.check(now=99.0) is None  # fires once
        assert [w["seq"] for w in wedged] == [3]
        assert (run_dir / mod.WEDGE_STACKS_FILENAME).read_text().startswith("=== stall at")
        on_disk = mod.read_wedge_report(run_dir / mod.WEDGE_REPORT_FILENAME)
        assert on_disk["program"] == "serve/b16" and on_disk["exit_code"] is None
        reports[name] = report
    jrep = reports["jax"]
    beacons = [_strip([r.pop("last_beacon")])[0] for r in (reports["torch"], jrep)]
    assert beacons[0] == beacons[1] == {
        "kind": "beacon", "program": "serve/b16", "phase": "search_wave", "index": 8,
    }
    assert _strip([reports["torch"]]) == _strip([{**jrep, "stacks_file": reports["torch"]["stacks_file"]}])
    assert reports["torch"]["elapsed_s"] == 6.5


# --- the heartbeat and the liveness probe ----------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_health_files_read_both_ways(tmp_path, writer):
    health_mod = PACKAGES[writer][2]
    clock = _Clock(100.0)
    mon = health_mod.HealthMonitor(tmp_path / "health.json", deadline_s=30.0, run_name="r0",
                                   clock=clock)
    mon.note_rollout(experiences=5, episodes=2)
    mon.note_utilization({"serve_move_latency_ms_p95": 12.5, "serve_sessions": 3, "other": 1})
    mon.set_device_info("NVIDIA H100 80GB HBM3", None, "unknown")
    clock.t = 103.0
    mon.write()
    reader = PACKAGES[OTHER[writer]][2]
    payload = reader.read_health(tmp_path / "health.json")
    assert payload["run"] == "r0" and payload["rollout_age_s"] == 3.0
    assert payload["episodes_played"] == 2 and payload["experiences_added"] == 5
    assert payload["utilization"] == {"serve_move_latency_ms_p95": 12.5, "serve_sessions": 3}
    now = payload["time"] + 1.0
    assert reader.health_verdict(payload, now=now) == health_mod.health_verdict(payload, now=now)
    assert reader.probe_run(tmp_path, now=now)["code"] == reader.PROBE_LIVE


def test_stall_watchdog_fires_and_recovers(tmp_path):
    clock = _Clock(0.0)
    mon = thealth.HealthMonitor(tmp_path / "health.json", deadline_s=10.0, clock=clock)
    stalls, recoveries = [], []
    dog = thealth.Watchdog(mon, deadline_s=10.0, on_stall=stalls.append,
                           on_recover=lambda: recoveries.append(1), clock=clock)
    clock.t = 5.0
    assert not dog.check()
    clock.t = 12.0
    assert dog.check() and dog.check() and stalls == [12.0]
    assert mon.snapshot()["stalled"] and mon.snapshot()["stall_count"] == 1
    mon.note_rollout(1, 0)
    assert not dog.check() and recoveries == [1] and not mon.snapshot()["stalled"]


NOW = 1_000.0


def _health(run_dir, *, time_s, stalled=False, deadline_s=10.0, pid=4242):
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "health.json").write_text(json.dumps(
        {"time": time_s, "pid": pid, "stalled": stalled, "watchdog_deadline_s": deadline_s}
    ))


def _intent(seq, *, t, deadline=5.0, pid=None, program="serve/b8"):
    rec = {"kind": "flight", "phase": "intent", "seq": seq, "program": program,
           "family": "serve", "time": t, "deadline_s": deadline}
    if pid is not None:
        rec["pid"] = pid
    return rec


def _seal(seq, *, t, ok=True, program="serve/b8"):
    return {"kind": "flight", "phase": "seal", "seq": seq, "ok": ok, "program": program,
            "family": "serve", "time": t, "wall_s": 0.5}


PROBE_CASES = {
    "missing": (None, []),
    "live": (dict(time_s=NOW - 1.0), []),
    "stale": (dict(time_s=NOW - 100.0), []),
    "stalled": (dict(time_s=NOW - 1.0, stalled=True), []),
    "overdue": (dict(time_s=NOW - 1.0), [_intent(7, t=NOW - 50.0)]),
    "sealed": (dict(time_s=NOW - 1.0), [_intent(7, t=NOW - 50.0), _seal(7, t=NOW - 49.0)]),
    "earlier-incarnation": (dict(time_s=NOW - 1.0), [_intent(7, t=NOW - 50.0, pid=1111)]),
    "same-incarnation": (dict(time_s=NOW - 1.0), [_intent(8, t=NOW - 50.0, pid=4242)]),
    "inside-slack": (dict(time_s=NOW - 1.0), [_intent(9, t=NOW - 6.0)]),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_run_matches_jax(tmp_path, case):
    health, flight = PROBE_CASES[case]
    if health is not None:
        _health(tmp_path, **health)
    if flight:
        _write_jsonl(tmp_path / "flight.jsonl", flight)
    ours = thealth.probe_run(tmp_path, now=NOW)
    assert ours == jhealth.probe_run(tmp_path, now=NOW)
    expected = {
        "missing": thealth.PROBE_MISSING, "stale": thealth.PROBE_UNHEALTHY,
        "stalled": thealth.PROBE_UNHEALTHY, "overdue": thealth.PROBE_DISPATCH_OVERDUE,
        "same-incarnation": thealth.PROBE_DISPATCH_OVERDUE,
    }.get(case, thealth.PROBE_LIVE)
    assert ours["code"] == expected, ours


# --- postmortem classification ---------------------------------------------

SINCE = 500.0


def _evidence_clean(d):
    _write_jsonl(d / "flight.jsonl", [_intent(1, t=600.0), _seal(1, t=601.0)])
    _health(d, time_s=602.0)


def _evidence_wedge(d):
    _write_jsonl(d / "flight.jsonl", [
        _intent(1, t=600.0), _seal(1, t=601.0), _intent(2, t=602.0),
    ])
    (d / "wedge_report.json").write_text(json.dumps(
        {"kind": "wedge", "time": 610.0, "program": "serve/b8", "family": "serve",
         "seq": 2, "elapsed_s": 9.0, "deadline_s": 5.0}
    ))


def _evidence_compile_hung(d):
    _write_jsonl(d / "flight.jsonl", [_intent(1, t=600.0, program="serve/b4")])


def _evidence_oom(d):
    _write_jsonl(d / "flight.jsonl", [_intent(1, t=600.0), _seal(1, t=601.0), _intent(2, t=602.0)])
    _write_jsonl(d / "metrics.jsonl", [{"kind": "util", "time": 601.5, "mem_utilization": 0.97}])


def _evidence_stalled(d):
    _write_jsonl(d / "flight.jsonl", [_intent(1, t=600.0), _seal(1, t=601.0)])
    _health(d, time_s=650.0, stalled=True)


def _evidence_beating(d):
    _write_jsonl(d / "flight.jsonl", [_intent(1, t=600.0), _seal(1, t=601.0)])
    _health(d, time_s=900.0, deadline_s=10.0)


def _evidence_preempted(d):
    _write_jsonl(d / "flight.jsonl", [_intent(1, t=600.0), _seal(1, t=601.0)])
    (d / "preempt_report.json").write_text(json.dumps(
        {"time": 700.0, "step": 12, "checkpointed_step": 12}
    ))


def _evidence_earlier_attempt(d):
    # The only torn intent and wedge report predate `since`: this death
    # must not inherit them.
    _write_jsonl(d / "flight.jsonl", [_intent(1, t=100.0), _intent(2, t=600.0), _seal(2, t=601.0)])
    (d / "wedge_report.json").write_text(json.dumps(
        {"kind": "wedge", "time": 110.0, "program": "serve/b8", "family": "serve"}
    ))


def _evidence_none(d):
    d.mkdir(parents=True, exist_ok=True)


EVIDENCE = {
    "clean": (_evidence_clean, "clean"),
    "wedge-report": (_evidence_wedge, "dispatch-hung"),
    "compile-hung": (_evidence_compile_hung, "compile-hung"),
    "oom": (_evidence_oom, "oom"),
    "host-stall": (_evidence_stalled, "host-stall"),
    "beating-idle": (_evidence_beating, "host-stall"),
    "preempted": (_evidence_preempted, "preempted"),
    "earlier-attempt": (_evidence_earlier_attempt, "clean"),
    "never-started": (_evidence_none, "never-started"),
}


@pytest.mark.parametrize("case", sorted(EVIDENCE))
def test_diagnose_matches_jax(tmp_path, case):
    write, verdict = EVIDENCE[case]
    write(tmp_path)
    ours = tsupervisor.diagnose(tmp_path, since=SINCE)
    assert ours == jsupervisor.diagnose(tmp_path, since=SINCE)
    assert ours["verdict"] == verdict and ours["exit_code"] == tflight.DOCTOR_EXIT_CODES[verdict]


def _fleet_event(event, t, **fields):
    return {"kind": "fleet", "event": event, "time": t, "pid": 1, **fields}


FLEET_CASES = {
    "clean": [
        _fleet_event("fleet-start", 1.0), _fleet_event("death", 2.0, replica="r0", rc=-9,
                                                       verdict="clean"),
        _fleet_event("respawn", 3.0, replica="r0"),
        _fleet_event("fleet-stop", 4.0, deaths=1, respawns=1, gaveup=[]),
    ],
    "mid-run-replica-wedge": [
        _fleet_event("fleet-start", 1.0),
        _fleet_event("death", 2.0, replica="r1", rc=113, verdict="dispatch-hung",
                     program="serve/b16", family="serve"),
    ],
    "mid-run-crash-loop": [
        _fleet_event("fleet-start", 1.0), _fleet_event("death", 2.0, replica="r0", rc=-9,
                                                       verdict="clean"),
    ],
    "gave-up": [
        _fleet_event("fleet-start", 1.0),
        _fleet_event("death", 2.0, replica="r0", rc=113, verdict="dispatch-hung",
                     program="serve/b8", family="serve"),
        _fleet_event("give-up", 3.0, replica="r0", reason="budget"),
        _fleet_event("fleet-stop", 4.0, deaths=1, respawns=0, gaveup=["r0"]),
    ],
    "host-stall": [_fleet_event("fleet-start", 1.0)],
    "never-started": [],
}


@pytest.mark.parametrize("case", sorted(FLEET_CASES) + ["torn-route"])
def test_classify_fleet_matches_jax(tmp_path, case):
    events = FLEET_CASES.get(case, FLEET_CASES["host-stall"])
    _write_jsonl(tmp_path / "fleet.jsonl", events)
    if case == "torn-route":
        _write_jsonl(tmp_path / "flight.jsonl", [
            {"kind": "flight", "phase": "intent", "seq": 3, "program": "fleet/route",
             "family": "fleet", "time": 1.5, "trace_id": "cd" * 16},
        ])
    ours = tfleet.classify_fleet(tmp_path)
    assert ours == jfleet.classify_fleet(tmp_path)
    if case == "torn-route":
        assert ours["verdict"] == "dispatch-hung" and ours["program"] == "fleet/route"


# --- the fleet SLO engine ---------------------------------------------------


def _slo_run(run_dir, slow_replica: bool):
    """A fleet run directory: parent util ticks, router sheds, two
    replicas' util records and flight seals."""
    _write_jsonl(run_dir / "metrics.jsonl", [
        {"kind": "util", "time": 1000.0 + 10 * i, "window_s": 10.0,
         "serve_requests_per_sec": 3.0 + i} for i in range(6)
    ])
    _write_jsonl(run_dir / "fleet.jsonl", [
        _fleet_event("fleet-start", 995.0),
        _fleet_event("shed", 1012.0, rejection="no-healthy-replica"),
        _fleet_event("exhausted", 1031.0),
        _fleet_event("death", 1020.0, replica="r0", rc=113, verdict="dispatch-hung"),
        _fleet_event("respawn", 1022.0, replica="r0"),
        _fleet_event("readmit", 1025.0, replica="r0"),
        _fleet_event("replica-reloaded", 1026.0, replica="r1", recompiles=0),
        _fleet_event("storm-summary", 1055.0, requests=64, completed=62, shed=2, lost=0,
                     requests_per_sec=1.2, move_latency_ms_p50=40.0, move_latency_ms_p95=90.0),
        _fleet_event("fleet-stop", 1060.0, deaths=1, respawns=1, gaveup=[]),
    ])
    for r, p95 in (("r0", 700.0 if slow_replica else 80.0), ("r1", 120.0)):
        rdir = run_dir / f"replica_{r}"
        _write_jsonl(rdir / "metrics.jsonl", [
            {"kind": "util", "time": 1005.0 + 10 * i, "serve_move_latency_ms_p95": p95 + i,
             "serve_window_requests": 4 + i} for i in range(5)
        ] + [{"kind": "util", "time": 1001.0}])
        _write_jsonl(rdir / "flight.jsonl", [
            _seal(i, t=1002.0 + i, ok=(i != 3 or r != "r0")) for i in range(8)
        ] + [_seal(99, t=1003.0, program="fleet/route") | {"family": "fleet"}])


@pytest.mark.parametrize("slow_replica", [False, True])
@pytest.mark.parametrize("windows", [tslo.DEFAULT_BURN_WINDOWS, ((30.0, 2.0), (120.0, 1.0))])
def test_slos_and_fleet_prom_match_jax(tmp_path, slow_replica, windows):
    _slo_run(tmp_path, slow_replica)
    ours = tslo.evaluate_slos(tmp_path, windows=windows)
    assert ours == jslo.evaluate_slos(tmp_path, windows=windows)
    assert ours["status"] in ("ok", "burning") and ours["exit_code"] == tslo.SLO_EXIT_CODES[ours["status"]]
    latency = next(s for s in ours["slos"] if s["name"] == "move-latency-p95")
    assert (latency["status"] == "burning") == slow_replica
    events = tledger.read_ledger(tmp_path / "fleet.jsonl")
    tsum, jsum = tperf.summarize_fleet(events), jperf.summarize_fleet(events)
    assert tsum == jsum and tsum["fleet_lost"] == 0 and tsum["fleet_shed_no_healthy"] == 1
    tslo.write_fleet_prometheus(tmp_path / "t.prom", tsum, ours, run_name="fl")
    jslo.write_fleet_prometheus(tmp_path / "j.prom", jsum, ours, run_name="fl")
    assert (tmp_path / "t.prom").read_text() == (tmp_path / "j.prom").read_text()
    assert "alphatriangle_slo_burn_rate{" in (tmp_path / "t.prom").read_text()


def test_slos_without_data(tmp_path):
    ours = tslo.evaluate_slos(tmp_path)
    assert ours == jslo.evaluate_slos(tmp_path) and ours["status"] == "no-data"


# --- utilization accounting --------------------------------------------------


def test_utilization_meter_matches_jax(monkeypatch):
    monkeypatch.delenv(tflops.PEAK_TFLOPS_ENV, raising=False)
    records = {}
    memory = [{"device": 0, "kind": "NVIDIA H100 80GB HBM3", "bytes_in_use": 3 << 30,
               "peak_bytes_in_use": 4 << 30, "bytes_limit": 80 << 30}]
    for name, mod in (("jax", jperf), ("torch", tperf)):
        clock = _Clock(0.0)
        meter = mod.UtilizationMeter(forward_flops=2_000_000, device_kind="NVIDIA H100 80GB HBM3",
                                     clock=clock)
        out = []
        for i in range(4):
            clock.t = 2.0 * i
            out.append(meter.tick(
                i * 3, episodes=i, experiences=10 * i, simulations=640 * i, reused_visits=7 * i,
                buffer_size=i, dispatch_wall_s=0.5 * i, device_memory=memory,
                extra={"serve_window_requests": i},
            ))
        records[name] = out
    assert records["torch"][0] is None
    # The port's peak table knows the H100 (989.4 dense bf16 TFLOP/s); the
    # JAX one lists TPU chips only. Everything else is the same record.
    peak_fields = ("peak_bf16_tflops", "peak_source", "mfu")

    def unpeaked(recs):
        return [{k: v for k, v in r.items() if k not in peak_fields} for r in _strip(recs)]

    assert unpeaked(records["torch"][1:]) == unpeaked(records["jax"][1:])
    assert all(r["peak_source"] == "unknown" and r["mfu"] is None for r in records["jax"][1:])
    rec = records["torch"][-1]
    assert rec["peak_source"] == "table" and rec["peak_bf16_tflops"] == 989.4
    assert rec["mfu"] == pytest.approx(rec["tflops_per_sec"] / 989.4, abs=5e-9)  # 8 decimals
    assert rec["chip_idle_fraction"] == 0.75 and rec["mem_bytes_limit"] == 80 << 30


@pytest.mark.parametrize("which", ["default", "tiny", "small"])
def test_forward_flops_match_jax(which, tiny_env_config, tiny_model_config, monkeypatch):
    from alphatriangle_tpu.config import EnvConfig, ModelConfig

    monkeypatch.delenv(tflops.PEAK_TFLOPS_ENV, raising=False)

    from torch_parity import small_model_config

    env_cfg = EnvConfig() if which == "default" else tiny_env_config
    model_cfg = {
        "default": ModelConfig(), "tiny": tiny_model_config,
        "small": small_model_config(tiny_env_config),
    }[which]
    assert tflops.forward_flops(torch_cfg(model_cfg), torch_cfg(env_cfg), env_cfg.action_dim) == (
        jflops.forward_flops(model_cfg, env_cfg, env_cfg.action_dim)
    )
    for kind in ("TPU v5 lite", "TPU v6e", ""):
        assert tflops.peak_bf16_tflops_info(kind) == jflops.peak_bf16_tflops_info(kind)
    # The port's table also knows its own card, which the JAX one does not.
    assert tflops.peak_bf16_tflops_info("NVIDIA H100 80GB HBM3") == (989.4, "table")


def test_device_memory_stats_without_a_context():
    """The heartbeat's memory read never creates a CUDA context: on this
    CPU-only process it reads nothing."""
    assert thealth.device_memory_stats() == []
    assert not torch.cuda.is_initialized()
