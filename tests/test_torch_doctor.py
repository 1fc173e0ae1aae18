"""`cli doctor --json` of the port against the JAX command
(`alphatriangle_tpu.cli.main`, which imports no JAX for `doctor`) over
the same directories: a clean port run (`cli train` on the CPU), that
run with wedge evidence (a wedge report and a beacon row; an unsealed
intent of a program that sealed before; one that never did), under
memory pressure, with a stalled heartbeat, with a preempt report, a
directory where nothing started, and a fleet parent's (its fleet.jsonl
and replica rings). Verdict, exit code, detail and evidence must be
equal; the exit code is the verdict's. The text form's first lines
agree too, and the port's doctor runs in a process whose imports of
torch, numpy and JAX raise.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from alphatriangle_tpu import cli as jcli
from alphatriangle_tpu_torch import cli
from alphatriangle_tpu_torch.telemetry.flight import DOCTOR_EXIT_CODES, read_flight
from torch_parity import plain_jax_programs  # noqa: F401 (autouse)
from torch_parity import tiny_preset

ROOT = Path(__file__).resolve().parent.parent

_NO_TORCH = (
    "import builtins, sys\n"
    "_real = builtins.__import__\n"
    "def _guard(name, *a, **k):\n"
    "    if name.split('.')[0] in ('torch', 'numpy', 'jax'):\n"
    "        raise ImportError('the doctor imported ' + name)\n"
    "    return _real(name, *a, **k)\n"
    "builtins.__import__ = _guard\n"
    "from alphatriangle_tpu_torch.cli import main\n"
    "sys.exit(main(sys.argv[1:]))\n"
)


@pytest.fixture(scope="module")
def clean_run(tmp_path_factory, tiny_env_config, tiny_model_config) -> Path:
    tmp = tmp_path_factory.mktemp("doctor")
    preset = tiny_preset(tmp / "tiny.json", tiny_env_config, tiny_model_config)
    root = tmp / "runs"
    proc = subprocess.run(
        [sys.executable, "-m", "alphatriangle_tpu_torch.cli", "train", "--preset", preset, "--device", "cpu",
         "--root-dir", str(root), "--run-name", "clean", "--no-auto-resume", "--no-tensorboard",
         "--max-steps", "3", "--self-play-batch", "2", "--batch-size", "4", "--min-buffer", "4",
         "--buffer-capacity", "64", "--rollout-chunk", "4", "--log-level", "WARNING"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return root / "AlphaTriangleTPUTorch" / "runs" / "clean"


def _append(path: Path, *records) -> None:
    with open(path, "a") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def _unsealed(run: Path, program: str) -> dict:
    ring = read_flight(run / "flight.jsonl")
    last = ring[-1]
    intent = {"kind": "flight", "phase": "intent", "seq": 1 + max(r.get("seq", 0) for r in ring),
              "program": program, "family": "learner" if program.startswith("learner") else "rollout",
              "avals": "B2xT4", "expected_s": 0.05, "deadline_s": 60.0, "t_mono": last["t_mono"] + 1.0,
              "time": last["time"] + 1.0, "pid": 4242}
    _append(run / "flight.jsonl", intent)
    return intent


def _make(kind: str, clean: Path, root: Path) -> Path:
    run = root / kind
    if kind == "never-started":
        run.mkdir(parents=True)
        return run
    if kind in ("fleet", "fleet-dead"):
        return _fleet_parent(run, stopped=kind == "fleet")
    shutil.copytree(clean, run)
    if kind in ("wedge", "oom"):
        intent = _unsealed(run, "self_play_chunk/t4")
        (run / "wedge_report.json").write_text(json.dumps({
            "kind": "wedge", "time": intent["time"] + 61.0, "pid": 4242, "program": intent["program"],
            "family": "rollout", "seq": intent["seq"], "avals": "B2xT4", "expected_s": 0.05,
            "deadline_s": 60.0, "elapsed_s": 61.0, "stacks_file": "wedge_stacks.txt", "exit_code": 113,
            "last_beacon": None,
        }))
        _append(run / "beacons.jsonl", {"kind": "beacon", "program": intent["program"],
                                         "phase": "search_wave", "index": 1, "t_mono": 1.0,
                                         "time": intent["time"] + 0.5, "pid": 4242})
    if kind == "torn-ring":
        _unsealed(run, "learner_step")
    if kind == "compile-hung":
        _unsealed(run, "learner_group/k9")
    if kind == "oom":
        health = json.loads((run / "health.json").read_text())
        health["device_memory"] = [{"device": 0, "kind": "cuda", "bytes_in_use": 95, "bytes_limit": 100}]
        (run / "health.json").write_text(json.dumps(health))
        (run / "metrics.jsonl").write_text("")  # the heartbeat's table is the freshest evidence
    if kind == "stalled":
        health = json.loads((run / "health.json").read_text())
        (run / "health.json").write_text(json.dumps(dict(health, stalled=True)))
    if kind == "preempted":
        (run / "preempt_report.json").write_text(json.dumps({
            "kind": "preempt", "time": 2e9, "pid": 4242, "step": 3, "checkpointed_step": 3,
            "exit_code": 114,
        }))
    return run


def _fleet_parent(run: Path, stopped: bool) -> Path:
    """A fleet parent's evidence: a replica's 113 death and its respawn,
    a shed, the storm summary and (`stopped`) the stop; an unsealed route
    intent, which names what a parent that died without a stop held."""
    run.mkdir(parents=True)
    t = 1_700_000_000.0
    ev = [
        ("fleet-start", {}), ("spawn", {"replica": "r0"}), ("spawn", {"replica": "r1"}),
        ("replica-ready", {"replica": "r0"}), ("replica-ready", {"replica": "r1"}),
        ("shed", {"rejection": "queue-full"}),
        ("death", {"replica": "r0", "rc": 113, "verdict": "dispatch-hung", "program": "serve/b4",
                   "family": "serve"}),
        ("respawn", {"replica": "r0", "slots": 2}), ("replica-ready", {"replica": "r0"}),
        ("readmit", {"replica": "r0"}), ("storm-summary", {"completed": 10}),
    ] + ([("fleet-stop", {})] if stopped else [])
    _append(run / "fleet.jsonl", *[{"kind": "fleet", "event": e, "time": t + i, "pid": 11, **kw}
                                   for i, (e, kw) in enumerate(ev)])
    _append(run / "flight.jsonl",
            {"kind": "flight", "phase": "intent", "seq": 1, "program": "fleet/route", "family": "fleet",
             "t_mono": 1.0, "time": t, "pid": 11, "trace_id": "ab" * 16},
            {"kind": "flight", "phase": "seal", "seq": 1, "program": "fleet/route", "family": "fleet",
             "wall_s": 0.5, "ok": True, "t_mono": 1.5, "time": t + 0.5},
            {"kind": "flight", "phase": "intent", "seq": 2, "program": "fleet/route", "family": "fleet",
             "t_mono": 2.0, "time": t + 1, "pid": 11, "trace_id": "cd" * 16})
    (run / "replica_r0").mkdir()
    return run


KINDS = ["clean", "wedge", "torn-ring", "compile-hung", "oom", "stalled", "preempted", "never-started",
         "fleet", "fleet-dead"]


@pytest.mark.parametrize("kind", KINDS)
def test_doctor_matches_jax(clean_run, tmp_path, capsys, kind):
    run = _make(kind, clean_run, tmp_path)
    ours = cli.main(["doctor", str(run), "--json"])
    got = json.loads(capsys.readouterr().out)
    theirs = jcli.main(["doctor", str(run), "--json"])
    want = json.loads(capsys.readouterr().out)
    assert ours == theirs == got["exit_code"] == DOCTOR_EXIT_CODES[got["verdict"]]
    assert got == want
    expect = {"clean": "clean", "wedge": "dispatch-hung", "torn-ring": "dispatch-hung",
              "compile-hung": "compile-hung", "oom": "oom", "stalled": "host-stall",
              "preempted": "preempted", "never-started": "never-started", "fleet": "clean",
              "fleet-dead": "dispatch-hung"}
    assert got["verdict"] == expect[kind]
    if kind == "wedge":
        assert "last beacon: self_play_chunk/t4 phase=search_wave index=1" in got["detail"]
    # The text form: the same first lines.
    assert cli.main(["doctor", str(run)]) == ours
    text = capsys.readouterr().out.splitlines()
    jcli.main(["doctor", str(run)])
    jtext = capsys.readouterr().out.splitlines()
    assert text[1:] == jtext[1:] and text[0] == jtext[0]


def test_doctor_by_run_name_and_newest(clean_run, tmp_path, capsys):
    """A run name under the runs root resolves in both packages' layouts;
    with none, the newest run; a root without runs exits 2."""
    root = tmp_path / "root"
    for app in ("AlphaTriangleTPUTorch", "AlphaTriangleTPU"):
        shutil.copytree(clean_run, root / app / "runs" / "clean")
    for argv in (["doctor", "clean", "--root-dir", str(root), "--json"],
                 ["doctor", "--root-dir", str(root), "--json"]):
        assert cli.main(argv) == jcli.main(argv) == 0
        got, want = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
        assert got.pop("run_dir").endswith("AlphaTriangleTPUTorch/runs/clean")
        assert want.pop("run_dir").endswith("AlphaTriangleTPU/runs/clean")
        assert got == want
    assert cli.main(["doctor", "--root-dir", str(tmp_path / "none")]) == 2


@pytest.mark.parametrize("kind", ["wedge", "fleet-dead"])
def test_doctor_imports_no_torch(clean_run, tmp_path, kind):
    run = _make(kind, clean_run, tmp_path)
    proc = subprocess.run([sys.executable, "-c", _NO_TORCH, "doctor", str(run)], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert "the doctor imported" not in proc.stderr, proc.stderr
    assert proc.returncode == DOCTOR_EXIT_CODES["dispatch-hung"] and proc.stdout.startswith(f"doctor {run}")
