"""The supervised chaos drill of `test_torch_chaos.py` and
`test_torch_quarantine.py`: `cli supervise -- train --fused-megastep` on
the CPU at the tiny preset's board and net, to step 6 with a checkpoint
every 2 (a dispatch deadline of at least 10 s, so a loaded machine's
slow dispatches do not wedge before the injected hang), the child on one
CPU thread. The parent runs in a process whose imports of torch, numpy
and JAX raise."""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

from alphatriangle_tpu_torch.telemetry.ledger import read_ledger

ROOT = Path(__file__).resolve().parent.parent
STEPS, FREQ, K = 6, 2, 2

_NO_TORCH = (
    "import builtins, sys\n"
    "_real = builtins.__import__\n"
    "def _guard(name, *a, **k):\n"
    "    if name.split('.')[0] in ('torch', 'numpy', 'jax'):\n"
    "        raise ImportError('the supervisor imported ' + name)\n"
    "    return _real(name, *a, **k)\n"
    "builtins.__import__ = _guard\n"
    "from alphatriangle_tpu_torch.cli import main\n"
    "sys.exit(main(sys.argv[1:]))\n"
)


def drill(tmp_path: Path, preset: str, faults: str, supervise_flags: tuple = ()) -> dict:
    """Run the supervised child with `faults` armed; at the first death
    record the checkpoint listing. Returns the parent's exit code, the
    events, the children's reports, the run dir and the at-death listing."""
    root = tmp_path / "runs"
    run = root / "AlphaTriangleTPUTorch" / "runs" / "c"
    argv = [
        "supervise", "--run-name", "c", "--root-dir", str(root), "--backoff-base", "0.1", *supervise_flags, "--",
        "train", "--preset", preset, "--device", "cpu", "--fused-megastep", "--max-steps", str(STEPS),
        "--self-play-batch", "2", "--batch-size", "4", "--min-buffer", "4", "--buffer-capacity", "64",
        "--rollout-chunk", "2", "--fused-learner-steps", str(K), "--checkpoint-freq", str(FREQ),
        "--no-tensorboard", "--dispatch-min-deadline", "10", "--dispatch-watchdog-poll", "0.1",
        "--log-level", "WARNING",
    ]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "ALPHATRIANGLE_FAULTS": faults,
           "ALPHATRIANGLE_FAULT_STATE_DIR": str(tmp_path / "f"), "PYTHONPATH": str(ROOT)}
    at_death, done = {}, threading.Event()

    def watch():
        while not done.is_set():
            log = run / "supervisor.jsonl"
            if log.exists() and any(e["event"] == "death" for e in read_ledger(log)):
                at_death.update({p.name: sorted(q.name for q in p.iterdir()) if p.is_dir() else None
                                 for p in (run / "checkpoints").iterdir()})
                return
            time.sleep(0.02)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        proc = subprocess.run([sys.executable, "-c", _NO_TORCH, *argv], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=300)
    finally:
        done.set()
        watcher.join(timeout=10)
    assert "the supervisor imported" not in proc.stderr, proc.stderr[-2000:]
    events = [e for e in read_ledger(run / "supervisor.jsonl") if e.get("kind") == "supervisor"]
    reports = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    return {"rc": proc.returncode, "events": events, "reports": reports, "run": run, "at_death": at_death,
            "stderr": proc.stderr}


def check_chain(d: dict, mode: str = "megastep") -> tuple:
    names = [e["event"] for e in d["events"]]
    assert d["rc"] == 0 and names == ["spawn", "death", "spawn", "complete"], (names, d["stderr"][-3000:])
    assert len(d["reports"]) == 1
    report = d["reports"][0]
    assert report["status"] == "completed" and report["steps"] == STEPS and report["mode"] == mode
    return d["events"][1], d["events"][2], report
