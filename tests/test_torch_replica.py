"""The port's serve replica and its service's tick window against the
JAX package's, and `cli fleet` end to end on the CPU.

- `serve_stats(drain)`: the same seeded dispatches through the JAX and
  the port `PolicyService` (exact stub nets) give the same keys, counts
  and fills, before a drain, at it and after it, when the window starts
  anew.
- `ReplicaServer`: both packages' servers, on the same JAX weights (the
  port's converted by `nn/convert.py`), play the same episode request
  lines through the `out=` seam and answer with the same moves, done
  and score; the control replies carry the JAX keys.
- A service with telemetry ledgers its ticks, brackets its dispatches
  in the flight ring and names the requests' traces.
- `cli fleet --smoke --device cpu`: two replica subprocesses on a tiny
  board, a `crash-serve` fault and a chaos kill; nothing is lost and
  the death -> verdict -> respawn -> re-admission chain is on
  `fleet.jsonl`.
"""

import io
import json
import os
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from alphatriangle_tpu.config import AlphaTriangleMCTSConfig as JaxMCTSConfig  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.mcts import BatchedMCTS as JaxMCTS  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.serving import PolicyService as JaxService  # noqa: E402
from alphatriangle_tpu.serving import replica as jreplica  # noqa: E402
from alphatriangle_tpu_torch.env import TriangleEnv  # noqa: E402
from alphatriangle_tpu_torch.features import FeatureExtractor  # noqa: E402
from alphatriangle_tpu_torch.mcts import BatchedMCTS  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork  # noqa: E402
from alphatriangle_tpu_torch.serving import PolicyService, build_serve_telemetry  # noqa: E402
from alphatriangle_tpu_torch.serving import replica as treplica  # noqa: E402
from alphatriangle_tpu_torch.telemetry.flight import read_flight  # noqa: E402
from alphatriangle_tpu_torch.telemetry.ledger import read_ledger  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import default_device_stats  # noqa: E402
from torch_parity import (  # noqa: E402
    CPU,
    JaxExactStub,
    TorchExactStub,
    converted_state_dict,
    inject_jax_noise,
    small_model_config,
    torch_cfg,
    torch_key,
)

ROOT = Path(__file__).resolve().parent.parent
# serve_stats keys the port adds to the JAX service's.
PORT_ONLY_STATS = {"serve_dispatches", "serve_reused_visits_total"}
WINDOW_FIELDS = (
    "serve_window_requests", "serve_batch_fill", "serve_fill", "serve_requests_total",
    "serve_sessions", "serve_sessions_admitted", "serve_sessions_retired",
    "serve_queue_depth", "serve_slots", "serve_bucket", "serve_weight_reloads",
    "serve_rung_switches",
)
PERCENTILES = (
    "serve_batch_ms_p50", "serve_batch_ms_p95", "serve_queue_wait_ms_p50",
    "serve_queue_wait_ms_p95", "serve_move_latency_ms_p50", "serve_move_latency_ms_p95",
)


@pytest.fixture(autouse=True)
def _jax_noise(monkeypatch):
    inject_jax_noise(monkeypatch)


class _Clock:
    """A service clock that moves 1 ms per read."""

    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


@pytest.fixture(scope="module")
def stub_worlds(tiny_env_config, tiny_model_config):
    default_device_stats()  # a search reads the stat-pack flag when built
    mcts_cfg = JaxMCTSConfig(max_simulations=4, max_depth=3, mcts_batch_size=4)
    jenv = JaxEnv(tiny_env_config)
    jfe = get_feature_extractor(jenv, tiny_model_config)
    jnet = SimpleNamespace(variables={}, weights_version=0)
    tenv = TriangleEnv(torch_cfg(tiny_env_config), device=CPU)
    tfe = FeatureExtractor(tenv, torch_cfg(tiny_model_config))
    tnet = NeuralNetwork(torch_cfg(tiny_model_config), torch_cfg(tiny_env_config), device=CPU)
    adim, atoms = tiny_env_config.action_dim, tiny_model_config.NUM_VALUE_ATOMS
    jm = JaxMCTS(jenv, jfe, JaxExactStub(adim, atoms), mcts_cfg, jax.numpy.asarray(tnet.support.numpy()))
    tm = BatchedMCTS(tenv, tfe, TorchExactStub(adim, atoms), torch_cfg(mcts_cfg), tnet.support)
    return (jenv, jfe, jnet, jm), (tenv, tfe, tnet, tm)


def _stats_pair(jsvc, tsvc, drain: bool):
    j, t = jsvc.serve_stats(drain=drain), tsvc.serve_stats(drain=drain)
    assert set(t) == set(j) | PORT_ONLY_STATS
    assert {k: t[k] for k in WINDOW_FIELDS} == {k: j[k] for k in WINDOW_FIELDS}
    for k in PERCENTILES:
        assert (t[k] is None) == (j[k] is None), k
    return t


def test_serve_stats_window_matches_jax(stub_worlds):
    """The JAX window semantics: counts and fills over the dispatches
    since the last drain; `drain=False` reads without resetting; a drain
    starts a new window while the run's totals go on."""
    (jenv, jfe, jnet, jm), (tenv, tfe, tnet, tm) = stub_worlds
    jsvc = JaxService(jenv, jfe, jnet, jm, slots=4, rng_seed=5, clock=_Clock())
    tsvc = PolicyService(tenv, tfe, tnet, tm, slots=4, rng_seed=5, clock=_Clock())
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    jsess, tsess = jsvc.open_sessions(keys), tsvc.open_sessions(torch_key(keys))

    def dispatch(n_requests):
        for js, ts in list(zip(jsess, tsess))[:n_requests]:
            jsvc.request_move(js.sid)
            tsvc.request_move(ts.sid)
        jres, tres = jsvc.dispatch(), tsvc.dispatch()
        assert [(r["slot"], r["action"], r["done"]) for r in tres] == [
            (r["slot"], r["action"], r["done"]) for r in jres]

    empty = _stats_pair(jsvc, tsvc, drain=False)
    assert empty["serve_window_requests"] == 0 and empty["serve_batch_fill"] is None
    dispatch(3)
    dispatch(2)
    peek = _stats_pair(jsvc, tsvc, drain=False)
    assert peek["serve_window_requests"] == 5 and peek["serve_batch_fill"] == 0.625
    assert peek["serve_fill"] == 0.5 and peek["serve_dispatches"] == 2
    assert peek["serve_move_latency_ms_p95"] >= peek["serve_queue_wait_ms_p95"] >= 0
    drained = _stats_pair(jsvc, tsvc, drain=True)  # the same window, then reset
    assert {k: drained[k] for k in WINDOW_FIELDS} == {k: peek[k] for k in WINDOW_FIELDS}
    after = _stats_pair(jsvc, tsvc, drain=False)
    assert after["serve_window_requests"] == 0 and after["serve_requests_total"] == 5
    assert after["serve_fill"] is None and after["serve_batch_fill"] is None
    assert all(after[k] is None for k in PERCENTILES)
    dispatch(1)
    last = _stats_pair(jsvc, tsvc, drain=True)
    assert last["serve_window_requests"] == 1 and last["serve_batch_fill"] == 0.25
    assert last["serve_requests_total"] == 6 and tsvc.batch_ms and len(tsvc.batch_ms) == 3


def test_service_telemetry_tick_flight_and_traces(stub_worlds, tmp_path, tiny_env_config,
                                                  tiny_model_config, monkeypatch):
    """With telemetry, a tick ledgers a util record carrying the window's
    `serve_*` fields and writes the heartbeat; each dispatch is one
    intent and one seal of `serve/b4`, naming the traces it served. On
    fake clocks (each flight bracket seals 0.25 s, the tick window is
    2 s) `chip_idle_fraction` is the window's share with no dispatch in
    flight: 1 - 2 x 0.25 / 2."""
    import time as real_time

    from alphatriangle_tpu_torch.telemetry import flight as flight_mod

    _, (tenv, tfe, tnet, tm) = stub_worlds
    tele = build_serve_telemetry(tmp_path, "svc", torch_cfg(tiny_env_config),
                                 torch_cfg(tiny_model_config), device="cpu")
    # The recorder reads perf_counter four times a bracket (intent, start,
    # seal, overhead): a wall of one step between start and seal.
    ticks = iter(0.25 * i for i in range(1000))
    monkeypatch.setattr(flight_mod, "time", SimpleNamespace(
        perf_counter=lambda: next(ticks), monotonic=real_time.monotonic, time=real_time.time))
    meter_now = iter([10.0, 12.0])
    tele.perf._clock = lambda: next(meter_now)
    svc = PolicyService(tenv, tfe, tnet, tm, slots=4, rng_seed=5, telemetry=tele)
    assert svc.tick() is None  # the meter's baseline tick
    a, b = svc.open_session(seed=1), svc.open_session(seed=2)
    svc.set_session_trace(a.sid, {"trace_id": "ab" * 16, "span_id": "cd" * 8})
    for _ in range(2):
        svc.request_move(a.sid)
        svc.request_move(b.sid)
        results = svc.dispatch()
        assert [r.get("trace_id") for r in results] == ["ab" * 16, None]
    record = svc.tick()
    assert record["kind"] == "util" and record["serve_window_requests"] == 4
    assert record["serve_batch_fill"] == 0.5 and record["device_kind"] == "cpu"
    assert record["chip_idle_fraction"] == 0.75
    assert read_ledger(tmp_path / "metrics.jsonl") == [record]
    assert json.loads((tmp_path / "health.json").read_text())["utilization"]["serve_batch_fill"] == 0.5
    flight = read_flight(tmp_path / "flight.jsonl")
    assert [(r["phase"], r["program"], r.get("trace_ids")) for r in flight] == [
        ("intent", "serve/b4", ["ab" * 16]), ("seal", "serve/b4", ["ab" * 16])] * 2
    assert svc.serve_stats(drain=False)["serve_window_requests"] == 0
    tele.close(step=svc.dispatch_count)
    assert (tmp_path / "trace.json").exists()


# --- the replica server --------------------------------------------------------


@pytest.fixture(scope="module")
def replica_worlds(tiny_env_config):
    """The JAX and the port (env, extractor, net, search) over the same
    small net, the port's weights converted from the JAX ones."""
    default_device_stats()  # a search reads the stat-pack flag when built
    model_cfg = small_model_config(tiny_env_config)
    mcts_cfg = JaxMCTSConfig(max_simulations=6, max_depth=4, mcts_batch_size=3)
    jenv = JaxEnv(tiny_env_config)
    jfe = get_feature_extractor(jenv, model_cfg)
    jnet = JaxNetwork(model_cfg, tiny_env_config, seed=3)
    jm = JaxMCTS(jenv, jfe, jnet.model, mcts_cfg, jnet.support)
    tenv = TriangleEnv(torch_cfg(tiny_env_config), device=CPU)
    tfe = FeatureExtractor(tenv, torch_cfg(model_cfg))
    tnet = NeuralNetwork(torch_cfg(model_cfg), torch_cfg(tiny_env_config),
                         state_dict=converted_state_dict(jnet), device=CPU)
    tm = BatchedMCTS(tenv, tfe, tnet.model, torch_cfg(mcts_cfg), tnet.support)
    return (jenv, jfe, jnet, jm), (tenv, tfe, tnet, tm), model_cfg


@pytest.fixture
def replica_pair(replica_worlds):
    """A JAX and a port PolicyService of 8 slots over `replica_worlds`,
    built inside the test, where the JAX compile cache is the disabled
    one of `plain_jax_programs`."""
    (jenv, jfe, jnet, jm), (tenv, tfe, tnet, tm), _ = replica_worlds
    return (JaxService(jenv, jfe, jnet, jm, slots=8, rng_seed=7),
            PolicyService(tenv, tfe, tnet, tm, slots=8, rng_seed=7))


def _play(server_mod, service, lines):
    """Every episode request handled before the first dispatch, then the
    dispatcher thread until every episode has replied: the dispatch
    sequence does not depend on thread timing."""
    out = io.StringIO()
    server = server_mod.ReplicaServer(service, None, tick_every=2, out=out)
    for line in lines:
        assert server._handle(json.loads(line))
    worker = threading.Thread(target=server._dispatch_loop, daemon=True)
    worker.start()
    for _ in range(6000):
        replies = [json.loads(r) for r in out.getvalue().splitlines()]
        if len(replies) == len(lines):
            break
        threading.Event().wait(0.01)
    server._stop.set()
    with server._cond:
        server._cond.notify_all()
    worker.join(timeout=10.0)
    return replies


def test_replica_episodes_match_jax(replica_pair):
    jsvc, tsvc = replica_pair
    lines = [json.dumps({"id": i, "kind": "episode", "seed": 11 + i, "max_moves": 5,
                         "trace_id": f"{i:032x}"}) for i in range(6)]
    jrep = sorted(_play(jreplica, jsvc, lines), key=lambda r: r["id"])
    trep = sorted(_play(treplica, tsvc, lines), key=lambda r: r["id"])
    assert all(r["ok"] for r in jrep), jrep
    assert [(r["id"], r["ok"], r["moves"], r["done"], r["score"], r["seed"], r["trace_id"])
            for r in trep] == [
        (r["id"], r["ok"], r["moves"], r["done"], r["score"], r["seed"], r["trace_id"])
        for r in jrep]
    assert set(trep[0]) == set(jrep[0])
    assert all(len(r["lat_ms"]) == r["moves"] >= 1 for r in trep)
    assert tsvc.dispatch_count == jsvc.dispatch_count > 0
    assert sum(r["done"] for r in trep) >= 1


def _control(server_mod, service, run_dir, env_cfg, model_cfg, build):
    """ping / stats / reload / an unknown kind / shutdown through
    `serve_forever` on a stdin of lines."""
    out = io.StringIO()
    telemetry = build(run_dir, "r0", env_cfg, model_cfg)
    server = server_mod.ReplicaServer(service, telemetry, out=out)
    lines = [json.dumps({"id": i, "kind": k}) for i, k in
             enumerate(["ping", "stats", "reload", "nonsense", "shutdown", "ping"])]
    stdin = io.StringIO("\n".join(lines[:1] + ["{torn"] + lines[1:]) + "\n")
    assert server.serve_forever(heartbeat_s=0.05, stdin=stdin) == 0
    return [json.loads(r) for r in out.getvalue().splitlines()]


def test_control_replies_have_the_jax_keys(replica_pair, replica_worlds, tmp_path,
                                           tiny_env_config):
    from alphatriangle_tpu.serving.service import build_serve_telemetry as jax_build

    jsvc, tsvc = replica_pair
    model_cfg = replica_worlds[2]
    jout = _control(jreplica, jsvc, tmp_path / "j", tiny_env_config, model_cfg, jax_build)
    tout = _control(treplica, tsvc, tmp_path / "t", torch_cfg(tiny_env_config),
                    torch_cfg(model_cfg), lambda *a: build_serve_telemetry(*a, device="cpu"))
    assert [r["id"] for r in tout] == [r["id"] for r in jout] == [0, 1, 2, 3, 4]
    for t, j in zip(tout, jout, strict=True):
        extra = PORT_ONLY_STATS if t.get("kind") == "stats" else set()
        assert set(t) == set(j) | extra, t.get("kind")
        assert t["ok"] == j["ok"]
    reload = tout[2]
    assert reload["recompiles"] == 0 and reload["cache_misses"] == 0 and reload["reloads"] >= 1
    assert tout[1]["cache_misses"] == tout[1]["cache_events"] == 0  # the CPU loads no kernel
    assert "unknown kind" in tout[3]["error"]


# --- cli fleet on the CPU ---------------------------------------------------------


def test_cli_fleet_storm_on_the_cpu(tmp_path, tiny_env_config, tiny_model_config):
    """Two replicas, a crash-serve fault in one dispatch, a chaos kill:
    every request completes or is shed, the failed dispatch sealed
    ok:false, and the killed replica's death -> verdict -> respawn ->
    ready -> re-admission chain lands in order."""
    run_dir = tmp_path / "AlphaTriangleTPUTorch" / "runs" / "fl"
    run_dir.mkdir(parents=True)
    (run_dir / "configs.json").write_text(json.dumps(
        {"env": tiny_env_config.model_dump(), "model": tiny_model_config.model_dump()}
    ))
    argv = [
        "fleet", "--smoke", "--device", "cpu", "--run-name", "fl", "--root-dir", str(tmp_path),
        "--replicas", "2", "--slots", "4", "--buckets", "2,4,8", "--sims", "2",
        "--requests", "40", "--concurrency", "6", "--max-moves", "4", "--timeout", "60",
        "--backoff-base", "0.2", "--quarantine-after", "1", "--tick-every", "2",
        "--replica-health-interval", "0.2", "--poll", "0.05", "--settle", "60",
        "--chaos-kill-after", "24", "--reload-after", "4",
    ]
    env = {**os.environ, "PYTHONPATH": str(ROOT), "ALPHATRIANGLE_FAULTS": "crash-serve@after=3",
           "ALPHATRIANGLE_FAULT_STATE_DIR": str(tmp_path / "faults")}
    proc = subprocess.run([sys.executable, "-m", "alphatriangle_tpu_torch.cli", *argv], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["lost"] == 0 and report["terminal"] == report["requests"] == 40
    assert report["completed"] + report["shed"] == 40 and report["completed"] > 0
    assert report["fleet"]["deaths"] >= 1 and report["fleet"]["reload_recompiles"] == 0
    assert (run_dir / "fleet.prom").exists() and report["slo"] in ("ok", "burning")
    assert (tmp_path / "faults" / "crash-serve.fired").exists()
    failed = [r for d in run_dir.glob("replica_*") for r in read_flight(d / "flight.jsonl")
              if r["phase"] == "seal" and not r["ok"]]
    assert any("injected serve-dispatch crash" in r["error"] for r in failed)
    events = [e for e in read_ledger(run_dir / "fleet.jsonl") if e["kind"] == "fleet"]
    kill = next(i for i, e in enumerate(events) if e["event"] == "chaos-kill")
    victim = events[kill]["replica"]
    lifecycle = ("chaos-kill", "death", "respawn", "replica-ready", "readmit")
    chain = [(e["event"], e) for e in events[kill:]
             if e.get("replica") == victim and e["event"] in lifecycle]
    names = [n for n, _ in chain]
    assert names[:2] == ["chaos-kill", "death"], names
    death = chain[1][1]
    assert death["rc"] == -9 and death["action"] == "restart" and death["verdict"]
    i = names.index("respawn")
    assert names[i:i + 3] == ["respawn", "replica-ready", "readmit"], names
    assert chain[i + 1][1]["device"] == "cpu" and chain[i + 1][1]["warm_aot"] is False
    assert sum(e["event"] == "replica-reloaded" for e in events) >= 1
