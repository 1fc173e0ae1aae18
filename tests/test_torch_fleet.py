"""The port's `FleetSupervisor` against the JAX package's, with scripted
replica processes, and the torch-free fleet parent.

The supervisor cases of `tests/test_fleet.py` run through both packages
on the same fake popen and fake clock: a replica wedges in its serve
dispatch and dies with 113, the death is classified from its run
directory, the policy quarantines it, it respawns onto the ladder's
lower rung and is re-admitted. The ledgered chains must be equal, event
for event and field for field, pids, times and trace ids aside. An
interactive fake replica answers the JSON-lines protocol, so the
handles, a rolling reload and a storm run through the real reader
threads. Last, a subprocess shows that the `cli fleet` parent imports
neither torch nor numpy nor JAX.
"""

import json
import os
import queue
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu.serving import fleet as jfleet  # noqa: E402
from alphatriangle_tpu.serving.buckets import BucketLadder as JaxLadder  # noqa: E402
from alphatriangle_tpu.supervise.policy import RecoveryPolicy as JaxPolicy  # noqa: E402
from alphatriangle_tpu.telemetry import perf as jperf  # noqa: E402
from alphatriangle_tpu_torch.serving import fleet as tfleet  # noqa: E402
from alphatriangle_tpu_torch.supervise.policy import RecoveryPolicy  # noqa: E402
from alphatriangle_tpu_torch.telemetry import perf as tperf  # noqa: E402
from alphatriangle_tpu_torch.telemetry.health import PROBE_UNHEALTHY  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
FLEETS = {"jax": (jfleet, JaxPolicy), "torch": (tfleet, RecoveryPolicy)}
# Fields that carry a process's pid, clocks or random trace ids.
VOLATILE = {"time", "pid", "replica_pid", "t_mono", "replica_time", "trace_id", "span_id",
            "parent_id", "drained_s"}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class FakeProc:
    """A replica process stand-in whose stdout is scripted lines."""

    _pids = iter(range(50_000, 60_000))

    def __init__(self, stdout_lines):
        self.stdout = list(stdout_lines)
        self.stdin = self
        self.pid = next(FakeProc._pids)
        self.returncode = None

    def write(self, line):
        pass

    def flush(self):
        pass

    def close(self):
        pass

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        return self.returncode


def fleet_popen(calls):
    def popen(argv, **kw):
        calls.append(list(argv))
        name = argv[argv.index("--name") + 1]
        return FakeProc([json.dumps({"kind": "ready", "name": name, "pid": 1}) + "\n"])

    return popen


def write_health(run_dir, *, time_s):
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "health.json").write_text(json.dumps(
        {"time": time_s, "pid": 4242, "stalled": False, "watchdog_deadline_s": 10.0}
    ))


def write_wedge_evidence(run_dir, program="serve/b8"):
    """What a replica's watchdog exit leaves: a wedge report, and a ring
    where the program sealed once before it hung."""
    now = time.time()
    records = [
        {"kind": "flight", "phase": "intent", "seq": 1, "program": program, "family": "serve",
         "time": now},
        {"kind": "flight", "phase": "seal", "seq": 1, "ok": True, "program": program,
         "family": "serve", "wall_s": 1.0, "time": now},
        {"kind": "flight", "phase": "intent", "seq": 2, "program": program, "family": "serve",
         "time": now},
    ]
    (run_dir / "flight.jsonl").write_text("".join(json.dumps(r) + "\n" for r in records))
    (run_dir / "wedge_report.json").write_text(json.dumps(
        {"kind": "wedge", "time": now, "program": program, "family": "serve", "seq": 2,
         "elapsed_s": 99.0, "deadline_s": 5.0}
    ))


def fleet_events(run_dir) -> list:
    return [e for e in (json.loads(line) for line in (run_dir / "fleet.jsonl").read_text().splitlines())
            if e.get("kind") == "fleet"]


def _stable(events) -> list:
    """The lifecycle in ledger order, volatile fields aside. A ready line
    is ledgered by the reader thread the moment it is read, so its place
    among the monitor's events is timing-dependent: it is left out here
    and counted by the callers."""
    return [{k: v for k, v in e.items() if k not in VOLATILE}
            for e in events if e["event"] != "replica-ready"]


def make_fleet(which, run_dir, calls, clock, **kw):
    mod, policy_cls = FLEETS[which]
    return mod.FleetSupervisor(
        run_dir, replicas=1, slots=8, sims=2, popen=fleet_popen(calls), now=clock,
        sleep=lambda s: None, probe_deadline_s=10.0,
        policy_factory=lambda: policy_cls(
            max_restarts=8, circuit_breaker_deaths=99, backoff_base_s=3.0, backoff_max_s=30.0,
            quarantine_after=1, clock=clock,
        ),
        **kw,
    )


def _wedge_chain(which, tmp_path):
    clock = FakeClock(t=1_000.0)
    calls: list = []
    fleet = make_fleet(which, tmp_path / which / "fleet", calls, clock)
    h = fleet.handles[0]
    fleet._spawn(h, "spawn")
    assert h.ready.wait(2.0)
    write_health(h.run_dir, time_s=clock.t - 0.5)
    fleet._probe(h)
    assert h.routable and fleet.readmissions == 1
    write_wedge_evidence(h.run_dir, program="serve/b8")
    h.served_moves = 24
    h.proc.returncode = 113
    fleet.poll_once()
    assert fleet.deaths == 1 and not h.routable
    clock.t += 1.0
    fleet.poll_once()
    assert fleet.respawns == 0  # inside the backoff
    clock.t += 3.0
    fleet.poll_once()
    assert fleet.respawns == 1 and h.ready.wait(2.0)
    write_health(h.run_dir, time_s=clock.t - 0.5)
    fleet.poll_once()
    assert h.routable and fleet.readmissions == 2
    # The reader thread sets `ready` before it ledgers the ready line.
    for _ in range(500):
        if sum(e["event"] == "replica-ready" for e in fleet_events(fleet.run_dir)) == 2:
            break
        time.sleep(0.01)
    argv = [[a.replace(str(tmp_path / which), "<run>") for a in c] for c in calls]
    return fleet, argv


def test_death_verdict_respawn_readmission_chain_matches_jax(tmp_path):
    tfl, targv = _wedge_chain("torch", tmp_path)
    jfl, jargv = _wedge_chain("jax", tmp_path)
    tevents, jevents = fleet_events(tfl.run_dir), fleet_events(jfl.run_dir)
    assert _stable(tevents) == _stable(jevents)
    assert [e["event"] for e in _stable(tevents)] == ["spawn", "readmit", "death", "respawn", "readmit"]
    death = next(e for e in tevents if e["event"] == "death")
    assert (death["rc"], death["verdict"], death["family"], death["program"]) == (
        113, "dispatch-hung", "serve", "serve/b8")
    assert death["overrides"] == {"SERVE_SLOTS__scale": 0.5, "TELEMETRY__BEACONS": True}
    assert death["progress_moves"] == 24
    # One ready line per incarnation; the port's also names the device.
    tready = [e for e in tevents if e["event"] == "replica-ready"]
    jready = [e for e in jevents if e["event"] == "replica-ready"]
    assert len(tready) == len(jready) == 2
    assert set(tready[0]) == set(jready[0]) | {"device"}
    # The same argv, the replica module aside: the respawn serves at 4.
    assert [a[2] for a in targv] == ["alphatriangle_tpu_torch.serving.replica"] * 2
    assert [a[3:] for a in targv] == [a[3:] for a in jargv]
    assert targv[1][targv[1].index("--slots") + 1] == "4"
    assert tfl.summary() == jfl.summary() and tfl.summary()["buckets"] == {"r0": 4}
    # The spawn events name the incarnation's trace, which the child
    # adopts through the env seam.
    spawns = [e for e in tevents if e["event"] in ("spawn", "respawn")]
    assert all(e["trace_id"] == tfl.trace_ctx.trace_id and e["parent_id"] for e in spawns)
    tsum = tperf.summarize_fleet(tevents)
    assert tsum == jperf.summarize_fleet(jevents) and tsum["fleet_deaths"] == 1


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_stale_heartbeat_evicts_until_it_recovers(tmp_path, which):
    clock = FakeClock(t=1_000.0)
    fleet = make_fleet(which, tmp_path / "fleet", [], clock)
    h = fleet.handles[0]
    fleet._spawn(h, "spawn")
    assert h.ready.wait(2.0)
    write_health(h.run_dir, time_s=clock.t - 0.5)
    fleet._probe(h)
    assert h.routable
    clock.t += 100.0
    fleet.poll_once()
    assert not h.routable and fleet.evictions == 1
    evict = next(e for e in fleet_events(fleet.run_dir) if e["event"] == "evict")
    assert evict["code"] == PROBE_UNHEALTHY
    write_health(h.run_dir, time_s=clock.t - 0.5)
    fleet.poll_once()
    assert h.routable and fleet.readmissions == 2


@pytest.mark.parametrize("ladder", [None, "12,48,96", "4,8,16"])
def test_quarantine_walks_the_same_ladder_as_jax(tmp_path, ladder):
    """One quarantine strike lands exactly one walk down the shared
    ladder, two strikes two, on both packages."""
    slot_counts = (48,) if ladder == "12,48,96" else (16,) if ladder else (1, 3, 5, 8, 16, 64)
    for slots in slot_counts:
        picked = {}
        for which, (mod, _) in FLEETS.items():
            fleet = mod.FleetSupervisor(tmp_path / f"{which}_{slots}", replicas=1, slots=slots,
                                        ladder=ladder, popen=fleet_popen([]))
            name = fleet.handles[0].name
            out = [fleet._effective_slots(name)]
            for scale in (0.5, 0.25):
                fleet._overrides[name] = {"SERVE_SLOTS__scale": scale}
                out.append(fleet._effective_slots(name))
            assert out[1] == fleet.ladder.walk_down(slots)
            assert out[2] == fleet.ladder.walk_down(slots, strikes=2) and out[2] in fleet.ladder
            picked[which] = (out, fleet.ladder.rungs, fleet.summary()["rungs"])
        assert picked["torch"] == picked["jax"]
    assert JaxLadder.from_spec(ladder, base=slot_counts[-1]).rungs == picked["torch"][1]


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_router_events_keep_the_fleet_ledger_kind(tmp_path, which):
    fleet = FLEETS[which][0].FleetSupervisor(tmp_path / "fleet", replicas=0)
    fleet.router_event({"event": "shed", "kind": "episode", "rejection": "queue-full"})
    events = fleet_events(tmp_path / "fleet")
    assert events[-1]["event"] == "shed" and events[-1]["kind"] == "fleet"
    assert events[-1]["request_kind"] == "episode"
    assert tperf.summarize_fleet(events)["fleet_sheds"] == 1


class ProtocolProc:
    """A replica process stand-in that answers the JSON-lines protocol:
    episodes of `moves` moves (done), ping, reload (0 recompiles),
    stats and shutdown."""

    _pids = iter(range(70_000, 80_000))

    def __init__(self, name: str, moves: int = 3):
        self.name = name
        self.moves = moves
        self.pid = next(ProtocolProc._pids)
        self.returncode = None
        self.stdin = self
        self._out: queue.Queue = queue.Queue()
        self._out.put(json.dumps({"kind": "ready", "name": name, "pid": self.pid, "slots": 8,
                                  "precision": "float32", "warm_aot": False, "device": "cpu"}))
        self.stdout = iter(self._out.get, None)

    def write(self, line):
        req = json.loads(line)
        kind, rid = req["kind"], req["id"]
        reply = {"id": rid, "ok": True, "kind": kind}
        if kind == "episode":
            reply.update(moves=self.moves, done=True, score=float(req["seed"]),
                         lat_ms=[1.0 + i for i in range(self.moves)], seed=req["seed"])
        elif kind == "reload":
            reply.update(reloads=1, cache_misses=0, recompiles=0)
        self._out.put(json.dumps(reply) + "\n")
        if kind == "shutdown":
            self.returncode = 0
            self._out.put(None)

    def flush(self):
        pass

    def close(self):
        pass

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        return self.returncode


def _storm(which, tmp_path):
    mod, _ = FLEETS[which]
    fleet = mod.FleetSupervisor(
        tmp_path / which, replicas=2, slots=8, popen=lambda argv, **kw: ProtocolProc(
            argv[argv.index("--name") + 1]), poll_s=0.01,
    )
    for h in fleet.handles:
        write_health(h.run_dir, time_s=time.time() + 3600.0)
    fleet.start()
    assert all(h.routable for h in fleet.handles)
    router = fleet.build_router(timeout_s=5.0, poll_s=0.001)
    storm = mod.run_fleet_load(router, fleet, requests=12, concurrency=3, max_moves=4, seed=2)
    reload = fleet.rolling_reload(drain_timeout_s=5.0, request_timeout_s=5.0)
    fleet.stop()
    return fleet, storm, reload


def test_storm_and_rolling_reload_match_jax(tmp_path):
    tfl, tstorm, treload = _storm("torch", tmp_path)
    jfl, jstorm, jreload = _storm("jax", tmp_path)
    timing = {"elapsed_s", "requests_per_sec", "request_s_p95"}
    assert {k: v for k, v in tstorm.items() if k not in timing} == {
        k: v for k, v in jstorm.items() if k not in timing}
    assert tstorm["completed"] == tstorm["requests"] == 12 and tstorm["lost"] == 0
    assert tstorm["moves"] == 36 and tstorm["move_latency_ms_p95"] == 3.0
    assert treload == jreload == {"replicas": 2, "recompiles": 0}
    tevents, jevents = fleet_events(tfl.run_dir), fleet_events(jfl.run_dir)
    names = [e["event"] for e in tevents]
    assert sorted(names) == sorted(e["event"] for e in jevents)
    assert names.count("replica-reloaded") == 2 and names[-1] == "fleet-stop"
    assert sum(h.episodes_ok for h in tfl.handles) == 12
    summary = tperf.summarize_fleet(tevents)
    assert summary["fleet_reload_recompiles"] == 0 and summary["fleet_completed"] == 12


_PARENT_ONLY = """
import json, sys
from alphatriangle_tpu_torch import cli
from alphatriangle_tpu_torch.serving import fleet, router
from alphatriangle_tpu_torch import supervise
from alphatriangle_tpu_torch.telemetry import slo, perf, health, flight, ledger
rc = cli.main(["fleet", "--replicas", "0", "--requests", "3", "--concurrency", "2",
               "--settle", "0", "--root-dir", sys.argv[1], "--device", "cuda"])
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "numpy", "jax", "jaxlib", "alphatriangle_tpu"))
print(json.dumps({"rc": rc, "leaked": leaked}))
"""


def test_fleet_parent_imports_neither_torch_nor_numpy(tmp_path):
    """`cli fleet` end to end in a parent that has no replica to spawn:
    every request is shed as no-healthy-replica, and the process never
    imported torch, numpy or anything of JAX."""
    proc = subprocess.run(
        [sys.executable, "-c", _PARENT_ONLY, str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    report, verdict = json.loads(lines[-2]), json.loads(lines[-1])
    assert verdict == {"rc": 0, "leaked": []}
    assert report["requests"] == report["shed"] == 3 and report["lost"] == 0
    assert report["shed_by_code"] == {"no-healthy-replica": 3}
    run_dir = tmp_path / "AlphaTriangleTPUTorch" / "runs" / "fleet"
    assert (run_dir / "fleet.prom").exists() and report["slo"] in ("ok", "burning")
