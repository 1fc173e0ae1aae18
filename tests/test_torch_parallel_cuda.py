"""`cli train --distributed --fused-megastep` on the card at a cut
width (64 lanes, batch 64, 2-move chunks, K = 2, 4 steps).

- train-dp1: a world of one over NCCL, against the same run without
  `--distributed`: the same losses and launch counts, and the
  checkpoint's parameters equal (bit for bit where two undistributed
  runs on the card agree bit for bit, else within rtol 2e-4, atol 2e-5).
- train-dp2-shared: two ranks sharing the card over gloo (`--dist-backend
  gloo`; ranks sharing a card without it raise): 32 lanes, a batch of 32
  and a 256-slot shard each, parameter digests equal after every
  megastep, 16 + 2 search launches a searched move and one PER count a
  megastep on each rank, rank 0 alone writing the run's singletons.

Marked `cuda`: skips without a card. The file imports no JAX, so on a
machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
LANES, BATCH, CAP, STEPS, K, MOVES = 64, 64, 512, 4, 2, 2

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ranks run the search and PER kernels")


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _argv(root: Path, run: str) -> list:
    return [sys.executable, "-m", "alphatriangle_tpu_torch.cli", "train", "--fused-megastep",
            "--device", "cuda", "--seed", "0", "--self-play-batch", str(LANES), "--batch-size", str(BATCH),
            "--min-buffer", "128", "--buffer-capacity", str(CAP), "--rollout-chunk", str(MOVES),
            "--fused-learner-steps", str(K), "--max-steps", str(STEPS), "--root-dir", str(root),
            "--run-name", run, "--no-auto-resume", "--no-tensorboard", "--log-level", "WARNING"]


def _launch(argvs: list) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(a, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for a in argvs]
    reports = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        reports.append(dict(json.loads(out.strip().splitlines()[-1]), pid=p.pid))
    return reports


def _dist(world: int, rank: int, port: int, backend: str) -> list:
    return ["--distributed", "--coordinator", f"localhost:{port}", "--num-processes", str(world),
            "--process-id", str(rank), "--dist-backend", backend]


def _params(root: Path, run: str) -> dict:
    path = root / "AlphaTriangleTPUTorch" / "runs" / run / "checkpoints" / f"step_{STEPS:08d}" / "train_state.pt"
    return torch.load(path, weights_only=True)["params"]


def _searched_moves(report: dict) -> int:
    return (report["warmup_chunks"] + report["megasteps"]) * MOVES


def test_world_of_one_over_nccl_is_the_undistributed_run(card, tmp_path):
    plain_a, plain_b, dist = _launch([
        _argv(tmp_path, "a"), _argv(tmp_path, "b"),
        _argv(tmp_path, "d") + _dist(1, 0, _port(), "auto"),
    ])
    assert dist["dp"]["backend"] == "nccl" and dist["dp"]["world"] == 1
    assert dist["kernel_launches"] == plain_a["kernel_launches"]
    assert dist["kernel_launches"]["per_sample"] == dist["megasteps"]
    a, b, d = (_params(tmp_path, run) for run in ("a", "b", "d"))
    repeatable = all(torch.equal(a[n], b[n]) for n in a)
    for name in a:
        if repeatable:
            assert torch.equal(a[name], d[name]), name
        else:
            torch.testing.assert_close(d[name], a[name], rtol=2e-4, atol=2e-5)


def test_two_ranks_share_the_card_over_gloo(card, tmp_path):
    port = _port()
    r0, r1 = _launch([_argv(tmp_path, "s") + _dist(2, r, port, "gloo") for r in range(2)])
    assert r0["dp"]["param_checksums"] == r1["dp"]["param_checksums"]
    assert len(r0["dp"]["param_checksums"]) == r0["megasteps"] > 0
    for r in (r0, r1):
        assert r["dp"]["backend"] == "gloo"
        launches = r["kernel_launches"]
        assert launches["gather_rows"] == 16 * _searched_moves(r)
        assert launches["backup_update"] == 2 * _searched_moves(r)
        assert launches["per_sample"] == r["megasteps"]
    run = tmp_path / "AlphaTriangleTPUTorch" / "runs" / "s"
    assert json.loads((run / "health.json").read_text())["pid"] == r0["pid"]
    assert r1["stats_writers"] == [] and r0["stats_writers"] == ["live_metrics"]


def test_ranks_sharing_the_card_without_gloo_raise(card, tmp_path):
    port = _port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(_argv(tmp_path, "x") + _dist(2, r, port, "auto"), cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert all(p.returncode != 0 for p in procs)
    assert any("share the card" in e for e in errs)
