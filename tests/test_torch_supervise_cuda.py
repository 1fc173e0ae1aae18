"""A supervised megastep child on the card that wedges and completes.

`cli supervise -- train --fused-megastep --device cuda` at a cut width
(64 lanes, batch 64, 2-move chunks, K = 2) to step 6 with a checkpoint
every 2, `hang-dispatch` at the 3rd megastep's dispatch (after step 4 is
committed): the child's dispatch watchdog exits 113 with CUDA work
queued; the supervisor restarts it with `TELEMETRY__BEACONS`; the
respawn gets a clean card, resumes at step 4, launches the beacon writer
and the search and PER kernels, and completes. Under `--quarantine-after
1` the same wedge quarantines the megastep family: the respawn runs the
synchronous loop (no PER kernel) from the megastep run's step 4. Marked
`cuda`: skips without a card. The file imports no JAX, so on a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_supervise_cuda.py
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu_torch.telemetry.flight import read_flight  # noqa: E402
from alphatriangle_tpu_torch.telemetry.ledger import read_ledger  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
LANES, STEPS, FREQ, K = 64, 6, 2, 2

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the supervised child runs the kernels")


def _warmup_chunks(tmp_path: Path) -> int:
    """Warm-up chunks of this configuration: a run to its first megastep."""
    proc = subprocess.run(_train_argv(tmp_path / "probe", 2), cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])["warmup_chunks"]


def _train_argv(root: Path, steps: int) -> list:
    return [sys.executable, "-m", "alphatriangle_tpu_torch.cli", "train", "--fused-megastep", "--device", "cuda",
            "--seed", "0", "--self-play-batch", str(LANES), "--batch-size", "64", "--min-buffer", "128",
            "--rollout-chunk", "2", "--fused-learner-steps", str(K), "--max-steps", str(steps),
            "--checkpoint-freq", str(FREQ), "--root-dir", str(root), "--run-name", "c", "--no-auto-resume",
            "--no-tensorboard", "--dispatch-min-deadline", "5", "--dispatch-watchdog-poll", "0.25",
            "--log-level", "WARNING"]


@pytest.mark.parametrize("quarantined", [False, True], ids=["megastep", "quarantined"])
def test_supervised_megastep_child_wedges_and_completes_on_the_card(card, tmp_path, quarantined):
    hang_at = _warmup_chunks(tmp_path) + 3
    root = tmp_path / "runs"
    child = _train_argv(root, STEPS)[3:]
    flags = ["--quarantine-after", "1"] if quarantined else []
    env = {**os.environ, "ALPHATRIANGLE_FAULTS": f"hang-dispatch@after={hang_at}",
           "ALPHATRIANGLE_FAULT_STATE_DIR": str(tmp_path / "faults"), "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-m", "alphatriangle_tpu_torch.cli", "supervise", "--run-name", "c", "--root-dir",
         str(root), "--backoff-base", "0.5", *flags, "--", *child],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
    )
    run = root / "AlphaTriangleTPUTorch" / "runs" / "c"
    events = [e for e in read_ledger(run / "supervisor.jsonl") if e.get("kind") == "supervisor"]
    assert proc.returncode == 0 and [e["event"] for e in events] == ["spawn", "death", "spawn", "complete"], (
        proc.stderr[-3000:])
    death, respawn = events[1], events[2]
    assert (death["rc"], death["verdict"], death["family"], death["progress_step"]) == (
        113, "dispatch-hung", "megastep", 4)
    assert respawn["overrides"] == ({"TELEMETRY__BEACONS": True, "FUSED_MEGASTEP": False} if quarantined
                                    else {"TELEMETRY__BEACONS": True})
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["status"] == "completed" and report["steps"] == STEPS and report["resumed_step"] == 4
    assert report["mode"] == ("sync" if quarantined else "megastep")
    moves = report["lane_moves"] // LANES
    assert report["kernel_launches"] == {"gather_rows": 16 * moves, "backup_update": 2 * moves,
                                         "per_sample": report["megasteps"], "subtree_promote": 0}
    assert report["beacon_launches"] > 0
    rows = [b for b in read_ledger(run / "beacons.jsonl") if b["time"] >= respawn["time"]]
    assert len(rows) == report["beacon_launches"]
    hung = [r for r in read_flight(run / "flight.jsonl") if r["phase"] == "intent" and r["seq"] == hang_at
            and r["time"] < respawn["time"]]
    assert [r["program"] for r in hung] == [f"megastep/t2_k{K}"]
