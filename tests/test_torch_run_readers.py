"""The port's run readers against the JAX package's, on the same files:

- `summarize_utilization` (whole run and windowed) and `summarize_league`
  return equal dicts from the port and from JAX over one seeded record
  list (util ticks, kind-less legacy ticks, serve and idle fields, league
  rounds, other kinds) and over the ledger of a port `cli train` run on
  the CPU.
- JAX's `read_health` / `health_verdict` read the port's `health.json`.
- `cli health` (and `--probe`) and `cli perf` give the JAX commands'
  exit codes on a live, a stale, a stalled and a missing run: 0 live,
  1 stalled or stale, 2 no heartbeat or ledger; `cli perf --json`
  prints the JAX summary. Both run in a process where importing torch,
  numpy or JAX raises.
- `format_eta` equals JAX's.
- A completed `cli train --preset <tuned json>` run ledgers the
  `tune_outcome` record JAX's `ledger_tune_outcome` writes for the same
  ledger.
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from alphatriangle_tpu import cli as jcli
from alphatriangle_tpu.autotune.artifact import ledger_tune_outcome as jax_tune_outcome
from alphatriangle_tpu.telemetry import health as jhealth
from alphatriangle_tpu.telemetry import perf as jperf
from alphatriangle_tpu.utils.helpers import format_eta as jax_format_eta
from alphatriangle_tpu_torch import cli
from alphatriangle_tpu_torch.telemetry import perf as tperf
from alphatriangle_tpu_torch.telemetry.health import health_verdict, read_health
from alphatriangle_tpu_torch.telemetry.ledger import read_ledger
from alphatriangle_tpu_torch.utils.helpers import format_eta
from torch_parity import plain_jax_programs  # noqa: F401 (autouse)
from torch_parity import tiny_preset

ROOT = Path(__file__).resolve().parent.parent
PORT_APP, JAX_APP = "AlphaTriangleTPUTorch", "AlphaTriangleTPU"

# A process whose imports of torch, numpy or JAX raise: the readers must
# run on the standard library.
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


def _seeded_records(seed: int) -> list:
    pick = np.random.default_rng(seed)
    out = []
    for i in range(14):
        r = {
            "kind": "util", "step": 3 * i, "time": 1000.0 + i, "window_s": float(pick.random() * 5),
            "learner_steps_per_sec": float(pick.random()), "moves_per_sec": float(pick.random() * 300),
            "games_per_hour": float(pick.random() * 50), "sims_per_sec": float(pick.random() * 1e4),
            "leaf_evals_per_sec": float(pick.random() * 1e4), "mcts_reused_visit_fraction": 0.0,
            "tflops_per_sec": float(pick.random()), "mfu": float(pick.random() * 0.01),
            "step_time_ms": None if i % 5 == 0 else float(pick.random() * 900),
            "device_kind": "NVIDIA H100 80GB HBM3", "peak_bf16_tflops": 989.4, "peak_source": "table",
            "buffer_fill": i / 14, "transfer_h2d_ms": float(pick.random()),
            "transfer_d2h_ms": float(pick.random() * 30), "compile_cache_hit_rate": None,
            "dispatches_per_iteration": float(1 + pick.integers(0, 4)),
            "mem_peak_bytes_in_use": int(pick.integers(1, 9)) << 30, "mem_bytes_in_use": 3 << 30,
            "mem_bytes_limit": 80 << 30, "chip_idle_fraction": float(pick.random()),
        }
        if i in (2, 3):
            del r["kind"]  # a legacy tick
        if i > 9:
            r.update(serve_move_latency_ms_p50=float(pick.random() * 100),
                     serve_move_latency_ms_p95=float(pick.random() * 300),
                     serve_queue_wait_ms_p50=1.0, serve_requests_per_sec=5.0, serve_bucket=16)
        out.append(r)
        out.append({"kind": "tick", "step": 3 * i, "means": {"Loss/total_loss": float(pick.random())}})
        if i % 4 == 1:
            out.append({
                "kind": "league", "step": 3 * i, "round": i, "pool_size": 2 + i // 4,
                "opponent_mix": {"a": 0.5, "b": 0.5}, "moves_ingested": int(pick.integers(0, 90)),
                "ingested_moves_per_sec": float(pick.random() * 40), "promotions": i // 5,
                "mean_staleness": None if i == 1 else float(pick.random()), "live_elo": 1000.0 + i,
                "stale_dropped_total": i, "weight_reloads": i,
            })
    return out


@pytest.mark.parametrize("window", [None, 4, 0])
def test_summaries_match_jax_on_seeded_records(window):
    records = _seeded_records(2)
    got = tperf.summarize_utilization(records, window=window)
    assert got == jperf.summarize_utilization(records, window=window)
    assert got["ticks"] == (14 if not window else window) and got["mfu"] is not None
    assert tperf.summarize_league(records) == jperf.summarize_league(records)
    assert tperf.summarize_league(records)["league_rounds"] == 4
    assert tperf.summarize_utilization([]) is None and tperf.summarize_league([]) is None


@pytest.fixture(scope="module")
def port_run(tmp_path_factory, tiny_env_config, tiny_model_config):
    """One `cli train` run of the port (the tiny preset, a tuned-preset
    artifact with a prediction) in a process of its own; returns (runs
    root, run directory, the report, the artifact)."""
    tmp = tmp_path_factory.mktemp("readers")
    preset = Path(tiny_preset(tmp / "tiny.json", tiny_env_config, tiny_model_config))
    payload = json.loads(preset.read_text())
    payload.update(run_name="tiny", candidate={"lanes": 2},
                   predicted={"games_per_hour": 50.0, "moves_per_sec": 5.0})
    preset.write_text(json.dumps(payload))
    root = tmp / "runs"
    proc = subprocess.run(
        [sys.executable, "-m", "alphatriangle_tpu_torch.cli", "train", "--preset", str(preset),
         "--device", "cpu", "--root-dir", str(root), "--run-name", "live", "--no-auto-resume",
         "--no-tensorboard", "--max-steps", "4", "--self-play-batch", "2", "--batch-size", "4",
         "--min-buffer", "4", "--buffer-capacity", "64", "--rollout-chunk", "4",
         "--log-level", "WARNING"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    return root, root / PORT_APP / "runs" / "live", report, payload


def test_summaries_match_jax_on_a_port_ledger(port_run):
    _, run_dir, report, _ = port_run
    records = read_ledger(run_dir / "metrics.jsonl")
    utils = [r for r in records if r.get("kind") == "util"]
    assert len(utils) == report["iterations"] - 1 >= 2
    got = tperf.summarize_utilization(records)
    assert got == jperf.summarize_utilization(records)
    assert got["ticks"] == len(utils) and got["device_kind"] == "cpu" and got["last_step"] == 4
    assert tperf.summarize_league(records) is None is jperf.summarize_league(records)


def test_jax_reads_the_port_heartbeat(port_run):
    _, run_dir, report, _ = port_run
    payload = jhealth.read_health(run_dir / "health.json")
    assert payload == read_health(run_dir / "health.json")
    assert payload["learner_step"] == report["steps"] == 4 and payload["run"] == "live"
    assert payload["experiences_added"] == report["rows_ingested"]
    assert payload["device_kind"] == "cpu" and payload["utilization"]["step"] == 4
    for age, live in ((1.0, True), (301.0, False)):
        got = health_verdict(payload, now=payload["time"] + age)
        assert got == jhealth.health_verdict(payload, now=payload["time"] + age)
        assert got[:2] == (live, age)


def _layouts(port_run, tmp_path) -> Path:
    """Four runs under one root in both packages' layouts: `live` (the
    port run's files), `stale` (its heartbeat 10,000 s old), `stalled`
    (flagged by the watchdog) and `missing` (a directory without files)."""
    _, run_dir, _, _ = port_run
    root = tmp_path / "root"
    for app in (PORT_APP, JAX_APP):
        runs = root / app / "runs"
        for name in ("live", "stale", "stalled"):
            shutil.copytree(run_dir, runs / name)
        health = json.loads((runs / "live" / "health.json").read_text())
        (runs / "stale" / "health.json").write_text(json.dumps(dict(health, time=health["time"] - 1e4)))
        (runs / "stalled" / "health.json").write_text(json.dumps(dict(health, stalled=True)))
        (runs / "missing").mkdir(parents=True)
    return root


@pytest.mark.parametrize("probe", [False, True])
def test_cli_health_exit_codes_match_jax(port_run, tmp_path, capsys, probe, monkeypatch):
    root = _layouts(port_run, tmp_path)
    # One wall clock for both commands: a heartbeat's printed age is
    # rounded to the second, and two reads of a moving clock straddled
    # a rounding boundary on a loaded machine.
    frozen = time.time()
    monkeypatch.setattr(time, "time", lambda: frozen)
    deadline = ["--deadline", "3600"]
    codes = {}
    for name in ("live", "stale", "stalled", "missing"):
        argv = ["health", name, "--root-dir", str(root), *deadline, *(["--probe"] if probe else [])]
        ours = cli.main(argv)
        out = capsys.readouterr().out
        theirs = jcli.main(argv)
        jout = capsys.readouterr().out
        assert ours == theirs, name
        codes[name] = ours
        if probe:
            got, want = json.loads(out), json.loads(jout)
            for volatile in ("time", "heartbeat_age_s", "run_dir"):
                got.pop(volatile, None), want.pop(volatile, None)
            assert got == want
        elif name != "missing":
            assert out.splitlines()[0] == jout.splitlines()[0]
    assert codes == {"live": 0, "stale": 1, "stalled": 1, "missing": 2}


def test_cli_perf_matches_jax(port_run, tmp_path, capsys):
    root = _layouts(port_run, tmp_path)
    for name, want_rc in (("live", 0), ("stale", 0), ("missing", 2)):
        for window in ([], ["--window", "2"]):
            argv = ["perf", name, "--root-dir", str(root), "--json", *window]
            ours = cli.main(argv)
            out = capsys.readouterr().out
            theirs = jcli.main(argv)
            jout = capsys.readouterr().out
            assert ours == theirs == want_rc, name
            if want_rc == 0:
                got, want = json.loads(out), json.loads(jout)
                assert got.pop("source").endswith(f"{PORT_APP}/runs/{name}/metrics.jsonl")
                assert want.pop("source").endswith(f"{JAX_APP}/runs/{name}/metrics.jsonl")
                assert got == want and got["programs"]
    # A ledger path directly, and the text summary.
    ledger = root / PORT_APP / "runs" / "live" / "metrics.jsonl"
    assert cli.main(["perf", str(ledger)]) == jcli.main(["perf", str(ledger)]) == 0
    text = capsys.readouterr().out
    assert "utilization  MFU" in text and "self_play_chunk/t4" in text


def test_readers_import_no_torch(port_run, tmp_path):
    root = _layouts(port_run, tmp_path)
    for argv, want in (
        (["health", "live", "--root-dir", str(root), "--deadline", "3600"], 0),
        (["health", "stale", "--root-dir", str(root), "--probe"], 1),
        (["perf", "live", "--root-dir", str(root)], 0),
        (["perf", "missing", "--root-dir", str(root)], 2),
        (["health", "--root-dir", str(root)], None),  # the newest run
    ):
        proc = subprocess.run(
            [sys.executable, "-c", _NO_TORCH, *argv], cwd=ROOT, capture_output=True, text=True,
            timeout=60,
        )
        assert "the reader imported" not in proc.stderr, proc.stderr
        if want is not None:
            assert proc.returncode == want, (argv, proc.stdout, proc.stderr)


@pytest.mark.parametrize(
    "seconds", [None, -1.0, float("nan"), float("inf"), 0, 59.9, 3600, 86399, 86400, 3 * 86400 + 3725.5]
)
def test_format_eta_matches_jax(seconds):
    assert format_eta(seconds) == jax_format_eta(seconds)


def test_tune_outcome_is_ledgered(port_run, tmp_path):
    _, run_dir, report, payload = port_run
    records = read_ledger(run_dir / "metrics.jsonl")
    outcomes = [r for r in records if r.get("kind") == "tune_outcome"]
    assert len(outcomes) == 1 and outcomes[0] == report["tune_outcome"]
    copy = tmp_path / "copy"
    shutil.copytree(run_dir, copy)
    want = jax_tune_outcome(copy, payload)
    got = dict(outcomes[0])
    got.pop("time"), want.pop("time")
    assert got == want
    assert got["predicted_games_per_hour"] == 50.0 and got["tuned_run_name"] == "tiny"
    assert got["observed_moves_per_sec"] is not None
