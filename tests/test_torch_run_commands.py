"""The commands that read a run, the port's against the JAX package's on
the same files: a port `cli train` run and a port `cli fleet` run on the
CPU (tiny board and net; the fleet with a chaos kill, so it has a death
and a respawn).

- `summarize_trace_file` and `cli trace` (a run's spans; none; missing).
- `merge_fleet_trace` and `cli trace --fleet`: the same events, flows,
  trace ids and clock offsets, the same `trace_fleet.json`.
- `render_frame` / `fleet_line` at a fixed now over the tailed files, and
  `cli watch --once` (a training run; a fleet parent with its SLO line).
- `find_latest_run_dir`.
- `load_comparable` / `compare_summaries` and `cli compare` exit codes
  over run directories, ledgers, a `cli perf --json` snapshot, a
  bench-style line written here, unreadable and missing sides.
- `cli slo --json` (windows, `--now`, `--prom`) and `cli perf --json`'s
  fleet fields over the fleet parent.
- `tb` / `ml` without the dashboard installed, `devices` without a card.
- Every parent command in a process whose imports of torch, numpy and
  JAX raise.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from alphatriangle_tpu import cli as jcli
from alphatriangle_tpu.stats import watch as jwatch
from alphatriangle_tpu.telemetry import merge as jmerge
from alphatriangle_tpu.telemetry import perf as jperf
from alphatriangle_tpu.telemetry import tracer as jtracer
from alphatriangle_tpu_torch import cli
from alphatriangle_tpu_torch.stats import watch
from alphatriangle_tpu_torch.telemetry import merge, perf, tracer
from alphatriangle_tpu_torch.telemetry.health import read_health
from torch_parity import plain_jax_programs  # noqa: F401 (autouse)
from torch_parity import tiny_preset

ROOT = Path(__file__).resolve().parent.parent
PORT_APP, JAX_APP = "AlphaTriangleTPUTorch", "AlphaTriangleTPU"
NOW = 2_000_000_000.0

_NO_TORCH = (
    "import builtins, sys\n"
    "_real = builtins.__import__\n"
    "def _guard(name, *a, **k):\n"
    "    if name.split('.')[0] in ('torch', 'numpy', 'jax'):\n"
    "        raise ImportError('the reader imported ' + name)\n"
    "    return _real(name, *a, **k)\n"
    "builtins.__import__ = _guard\n"
    "from alphatriangle_tpu_torch.cli import main\n"
    "sys.exit(main(sys.argv[1:]))\n"
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tiny_env_config, tiny_model_config) -> dict:
    """A `cli train` run and a `cli fleet` run of the port, started together,
    under one runs root; the same directories copied into the JAX layout
    of a second root."""
    tmp = tmp_path_factory.mktemp("readers")
    root = tmp / "port"
    preset = tiny_preset(tmp / "tiny.json", tiny_env_config, tiny_model_config)
    fleet_dir = root / PORT_APP / "runs" / "fl"
    fleet_dir.mkdir(parents=True)
    (fleet_dir / "configs.json").write_text(json.dumps(
        {"env": tiny_env_config.model_dump(), "model": tiny_model_config.model_dump()}
    ))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    train = subprocess.Popen(
        [sys.executable, "-m", "alphatriangle_tpu_torch.cli", "train", "--preset", preset, "--device", "cpu",
         "--root-dir", str(root), "--run-name", "tr", "--no-auto-resume", "--no-tensorboard",
         "--max-steps", "4", "--self-play-batch", "2", "--batch-size", "4", "--min-buffer", "4",
         "--buffer-capacity", "64", "--rollout-chunk", "4", "--log-level", "WARNING"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    fleet = subprocess.run(
        [sys.executable, "-m", "alphatriangle_tpu_torch.cli", "fleet", "--smoke", "--device", "cpu",
         "--run-name", "fl", "--root-dir", str(root), "--replicas", "2", "--slots", "2", "--buckets", "2",
         "--sims", "2", "--requests", "12", "--concurrency", "4", "--max-moves", "3", "--timeout", "60",
         "--backoff-base", "0.2", "--tick-every", "2", "--replica-health-interval", "0.2", "--poll", "0.05",
         "--settle", "60", "--chaos-kill-after", "6"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180,
    )
    out, err = train.communicate(timeout=180)
    assert train.returncode == 0, err[-3000:]
    assert fleet.returncode == 0, fleet.stderr[-3000:]
    jroot = tmp / "jax"
    for name in ("tr", "fl"):
        shutil.copytree(root / PORT_APP / "runs" / name, jroot / JAX_APP / "runs" / name)
    return {"root": root, "jroot": jroot, "train": root / PORT_APP / "runs" / "tr", "fleet": fleet_dir,
            "tmp": tmp}


def _both(argv_port: list, argv_jax: list, capsys) -> tuple:
    ours = cli.main(argv_port)
    out = capsys.readouterr()
    theirs = jcli.main(argv_jax)
    jout = capsys.readouterr()
    return ours, out, theirs, jout


def test_summarize_trace_file_matches_jax(runs, tmp_path):
    path = runs["train"] / "trace.json"
    for top in (1, 20):
        got = tracer.summarize_trace_file(path, top=top)
        assert got == jtracer.summarize_trace_file(path, top=top)
    assert {r["name"] for r in tracer.summarize_trace_file(path)} >= {"rollout", "train"}
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps([
        {"name": "a", "ph": "X", "ts": 0, "dur": 5, "tid": 1}, {"name": "a", "ph": "X", "ts": 9, "dur": 2, "tid": 2},
        {"name": "b", "ph": "i", "ts": 3}, "junk", {"name": "c", "ph": "X", "ts": 1, "tid": 1},
    ]))
    assert tracer.summarize_trace_file(bare) == jtracer.summarize_trace_file(bare)
    with pytest.raises(ValueError):
        tracer.summarize_trace_file(runs["train"] / "flight.jsonl")


def _strip_paths(text: str) -> list:
    return [line for line in text.splitlines() if "/" not in line]


def test_cli_trace_matches_jax(runs, capsys, tmp_path):
    for name, extra in (("tr", []), ("fl", ["--fleet"]), ("tr", ["--fleet"]), ("missing", []),
                        ("fl", ["--top", "1"])):
        ours, out, theirs, jout = _both(
            ["trace", name, "--root-dir", str(runs["root"]), *extra],
            ["trace", name, "--root-dir", str(runs["jroot"]), *extra], capsys,
        )
        assert ours == theirs, (name, extra, out.err, jout.err)
        assert _strip_paths(out.out) == _strip_paths(jout.out)
    assert cli.main(["trace", "tr", "--root-dir", str(runs["root"])]) == 0
    assert "rollout" in capsys.readouterr().out


def test_merge_fleet_trace_matches_jax(runs, tmp_path):
    ours = merge.merge_fleet_trace(runs["fleet"], out_path=tmp_path / "port.json")
    theirs = jmerge.merge_fleet_trace(runs["fleet"], out_path=tmp_path / "jax.json")
    assert ours.pop("path") != theirs.pop("path")
    assert ours == theirs
    assert ours["flows"] > 0 and ours["replicas"] == 2 and ours["processes"] >= 3
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads((tmp_path / "jax.json").read_text())
    with pytest.raises(FileNotFoundError):
        merge.merge_fleet_trace(runs["train"])


def _frame(mod, run: Path, now: float, monkeypatch) -> str:
    monkeypatch.setattr(time, "time", lambda: now)
    state, fleet_state = mod.WatchState(), mod.FleetWatchState()
    mod.tail_live_metrics(run / "live_metrics.jsonl", state, 0)
    mod.tail_ledger_utils(run / "metrics.jsonl", state, 0)
    mod.tail_flight(run / "flight.jsonl", state, 0)
    mod.tail_fleet(run / "fleet.jsonl", fleet_state, 0)
    frame = mod.render_frame(state, run.name, health=read_health(run / "health.json"))
    return frame + "\n" + str(mod.fleet_line(fleet_state))


@pytest.mark.parametrize("which", ["train", "fleet"])
def test_render_frame_matches_jax(runs, monkeypatch, which):
    run = runs[which]
    health = read_health(run / "health.json")
    last = health["time"] if health else max(json.loads(line)["time"] for line in open(run / "fleet.jsonl"))
    for now in (NOW, last + 3.0):
        got = _frame(watch, run, now, monkeypatch)
        assert got == _frame(jwatch, run, now, monkeypatch)
    assert got.startswith(f"run {run.name} @ step")
    if which == "fleet":
        assert "routable" in got and "deaths 1" in got


def test_cli_watch_once_matches_jax(runs, capsys, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    for name in ("tr", "fl"):
        ours, out, theirs, jout = _both(
            ["watch", "--run-name", name, "--root-dir", str(runs["root"]), "--once"],
            ["watch", "--run-name", name, "--root-dir", str(runs["jroot"]), "--once"], capsys,
        )
        assert ours == theirs == 0 and out.out == jout.out
    assert "slo[" in out.out


def test_find_latest_run_dir_matches_jax(runs, tmp_path):
    runs_root = runs["root"] / PORT_APP / "runs"
    assert watch.find_latest_run_dir(runs_root) == jwatch.find_latest_run_dir(runs_root) is not None
    assert watch.find_latest_run_dir(tmp_path / "none") is jwatch.find_latest_run_dir(tmp_path / "none") is None


@pytest.fixture
def sides(runs, tmp_path, capsys) -> dict:
    """One run's comparable sides: its directory, its ledger, its `cli perf
    --json` snapshot, that snapshot with throughputs cut by half, a bench
    line, junk, and a path that does not exist."""
    assert cli.main(["perf", str(runs["train"]), "--json"]) == 0
    snapshot = json.loads(capsys.readouterr().out)
    paths = {"dir": str(runs["train"]), "ledger": str(runs["train"] / "metrics.jsonl"),
             "fleet": str(runs["fleet"])}
    (tmp_path / "snap.json").write_text(json.dumps(snapshot))
    slow = dict(snapshot, moves_per_sec=snapshot["moves_per_sec"] / 2,
                learner_steps_per_sec=snapshot["learner_steps_per_sec"] / 2)
    (tmp_path / "slow.json").write_text(json.dumps(slow))
    (tmp_path / "bench.json").write_text(json.dumps({
        "metric": "self_play_games_per_hour", "value": snapshot["games_per_hour"] or 1.0,
        "extra": {"moves_per_sec": snapshot["moves_per_sec"], "learner_steps_per_sec_fused": 0.5,
                  "flops": {"self_play_mfu": 0.001}, "device_kind": "cpu"},
    }))
    (tmp_path / "junk.json").write_text("{nope")
    (tmp_path / "other.json").write_text(json.dumps({"metric": "other"}))
    for name in ("snap", "slow", "bench", "junk", "other"):
        paths[name] = str(tmp_path / f"{name}.json")
    paths["missing"] = str(tmp_path / "missing")
    return paths


def test_load_comparable_matches_jax(sides):
    for name, target in sides.items():
        assert perf.load_comparable(target) == jperf.load_comparable(target), name
    a, _ = perf.load_comparable(sides["slow"])
    b, _ = perf.load_comparable(sides["dir"])
    for threshold in (0.1, 0.6):
        for metrics in (None, ("moves_per_sec",), ("mfu", "serve_move_latency_ms_p95")):
            assert perf.compare_summaries(a, b, threshold, metrics) == jperf.compare_summaries(
                a, b, threshold, metrics)
    assert perf.COMPARE_METRICS == jperf.COMPARE_METRICS and perf.LOWER_IS_BETTER == jperf.LOWER_IS_BETTER


@pytest.mark.parametrize(
    "a,b,extra,want",
    [
        ("dir", "dir", [], 0), ("ledger", "snap", ["--json"], 0), ("slow", "dir", [], 1),
        ("slow", "dir", ["--json", "--threshold", "0.6"], 0), ("slow", "snap", ["--metrics", "moves_per_sec,learner_steps_per_sec", "--threshold", "0.6"], 0),
        ("slow", "snap", ["--metrics", "mfu"], 2),
        ("bench", "snap", ["--json"], None), ("junk", "dir", [], 2), ("missing", "dir", [], 2),
        ("other", "dir", [], 2), ("fleet", "fleet", ["--json"], 0), ("dir", "snap", ["--metrics", "nope"], 2),
    ],
)
def test_cli_compare_matches_jax(sides, capsys, a, b, extra, want):
    argv = ["compare", sides[a], sides[b], *extra]
    ours, out, theirs, jout = _both(argv, argv, capsys)
    assert ours == theirs and (want is None or ours == want)
    assert out.out == jout.out


@pytest.mark.parametrize(
    "extra", [["--json"], ["--json", "--window", "60:2", "--window", "600:1"], ["--json", "--now", "1"],
              ["--json", "--latency-threshold", "1"], [], ["--window", "bad"]],
)
def test_cli_slo_matches_jax(runs, capsys, extra):
    argv = ["slo", str(runs["fleet"]), *extra]
    ours, out, theirs, jout = _both(argv, argv, capsys)
    assert ours == theirs
    if "--json" in extra:
        got = json.loads(out.out)
        assert got == json.loads(jout.out) and ours == got["exit_code"]
    else:
        assert out.out == jout.out


def test_cli_slo_prom_matches_jax(runs, capsys):
    prom = runs["fleet"] / "fleet.prom"
    texts = []
    for main in (cli.main, jcli.main):
        prom.unlink(missing_ok=True)
        main(["slo", str(runs["fleet"]), "--prom", "--now", str(NOW)])
        texts.append(prom.read_text())
    capsys.readouterr()
    assert texts[0] == texts[1] and "fleet_" in texts[0]


def test_cli_perf_fleet_fields_match_jax(runs, capsys):
    argv = ["perf", str(runs["fleet"]), "--json"]
    ours, out, theirs, jout = _both(argv, argv, capsys)
    assert ours == theirs == 0
    got, want = json.loads(out.out), json.loads(jout.out)
    assert got == want
    fleet = {k: v for k, v in got.items() if k.startswith("fleet_")}
    assert fleet["fleet_deaths"] >= 1 and fleet["fleet_respawns"] >= 1
    assert cli.main(["perf", str(runs["fleet"])]) == 0
    assert "  fleet        move p50" in capsys.readouterr().out


@pytest.mark.parametrize("command", ["tb", "ml"])
def test_dashboards_not_installed(monkeypatch, capsys, command):
    monkeypatch.setitem(sys.modules, "tensorboard", None)
    monkeypatch.setitem(sys.modules, "mlflow", None)
    ours, out, theirs, jout = _both([command], [command], capsys)
    assert ours == theirs == 1 and out.err == jout.err and "is not installed" in out.err


def test_devices_without_a_card(capsys):
    assert cli.main(["devices"]) == 1
    err = capsys.readouterr().err
    assert err.startswith("no CUDA device (torch ")


def test_parent_commands_import_no_torch(runs, tmp_path):
    root = str(runs["root"])
    for argv, want in (
        (["trace", "tr", "--root-dir", root], 0),
        (["trace", "fl", "--root-dir", root, "--fleet"], 0),
        (["watch", "--run-name", "fl", "--root-dir", root, "--once"], 0),
        (["compare", str(runs["train"]), str(runs["train"])], 0),
        (["slo", str(runs["fleet"]), "--json"], None),
        (["perf", str(runs["fleet"]), "--json"], 0),
        (["doctor", "fl", "--root-dir", root, "--json"], None),
        (["supervise", "--run-name", "sv", "--root-dir", str(tmp_path), "--", "eval", "--help"], 0),
    ):
        proc = subprocess.run([sys.executable, "-c", _NO_TORCH, *argv], cwd=ROOT, capture_output=True,
                              text=True, timeout=120)
        assert "the reader imported" not in proc.stderr, (argv, proc.stderr[-2000:])
        if want is not None:
            assert proc.returncode == want, (argv, proc.stdout[-1000:], proc.stderr[-2000:])
    events = [json.loads(line)["event"] for line in
              (tmp_path / PORT_APP / "runs" / "sv" / "supervisor.jsonl").read_text().splitlines()]
    assert events == ["spawn", "complete"]
