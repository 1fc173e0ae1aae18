"""`cli train --distributed` of the port on the CPU (gloo ranks).

- A world of one (`--distributed` over a `FileStore`, NCCL's role taken
  by gloo on the CPU) trains the undistributed run's parameters bit for
  bit in the megastep: the gradient bucket's all-reduce over one rank is
  the gradient itself.
- Two ranks in the synchronous loop, on their own host rings and on the
  sharded device ring: equal step counts and parameter digests.
- Two ranks (`cli train` subprocesses, `--coordinator file://...`)
  train a megastep run: their parameter digests agree after every
  megastep; rank 0 alone writes the run directory's singletons, as in
  JAX `tests/test_distributed.py::test_two_process_train_step`
  (`configs.json`, checkpoints and `meta.json`, the live file, the
  ledger and the heartbeat, whose pid is rank 0's); rank 1 opens no
  writer. The checkpoint's counters and the utilization records count
  both ranks' lanes.
- The two-rank run's checkpoint and spill (the shards gathered on rank 0)
  resume in a one-process `cli train --fused-megastep` (JAX
  `tests/test_megastep_sharded.py:412`), and a one-process run's resume
  in two ranks, each keeping its stripe of the spill.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu_torch import cli  # noqa: E402
from torch_parity import reset_device_stats  # noqa: E402, F401 (autouse: `cli train` runs in-process)
from torch_parity import tiny_preset  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TRAIN = ["--device", "cpu", "--self-play-batch", "4", "--batch-size", "8", "--min-buffer", "8",
         "--buffer-capacity", "64", "--rollout-chunk", "3", "--fused-learner-steps", "2",
         "--no-tensorboard", "--seed", "3"]


@pytest.fixture(scope="module")
def preset(tmp_path_factory, tiny_env_config, tiny_model_config):
    return tiny_preset(tmp_path_factory.mktemp("preset") / "p.json", tiny_env_config,
                       tiny_model_config)


def _run_dir(root, run) -> Path:
    return Path(root) / "AlphaTriangleTPUTorch" / "runs" / run


def _in_process(capsys, *args) -> dict:
    assert cli.main(["train", *args]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _ranks(tmp_path, world, *args) -> list:
    """`world` cli train ranks over one FileStore; their reports and pids."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    store = tmp_path / f"store{len(list(tmp_path.glob('store*')))}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "alphatriangle_tpu_torch.cli", "train", *args, "--distributed",
             "--coordinator", f"file://{store}", "--num-processes", str(world), "--process-id", str(r)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(world)
    ]
    reports = []
    for r, p in enumerate(procs):
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
        reports.append(dict(json.loads(out.strip().splitlines()[-1]), pid=p.pid))
    return reports


def _params(root, run, step) -> dict:
    state = torch.load(_run_dir(root, run) / "checkpoints" / f"step_{step:08d}" / "train_state.pt",
                       weights_only=True)
    return state["params"]


def test_world_of_one_is_the_undistributed_run(tmp_path, capsys, preset):
    flags = [*TRAIN, "--preset", preset, "--max-steps", "4", "--root-dir", str(tmp_path),
             "--no-auto-resume", "--fused-megastep"]
    plain = _in_process(capsys, *flags, "--run-name", "plain")
    dist = _in_process(capsys, *flags, "--run-name", "dist", "--distributed", "--coordinator",
                       f"file://{tmp_path}/store", "--num-processes", "1", "--process-id", "0")
    assert not torch.distributed.is_initialized()  # the runner left its group
    assert dist["dp"]["world"] == 1 and dist["dp"]["backend"] == "gloo"
    assert plain["dp"]["backend"] is None and plain["steps"] == dist["steps"] == 4
    assert plain["losses"] == dist["losses"]
    a, b = _params(tmp_path, "plain", 4), _params(tmp_path, "dist", 4)
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("ring", ["off", "on"])
def test_two_rank_synchronous_loop(tmp_path, preset, ring):
    """The synchronous loop over two ranks: each rank's own host ring
    drawing B / dp rows ("off"), or the sharded device ring drawing each
    rank's stratum of B ("on"); the step counts from the global rows, the
    digests equal after every iteration."""
    r0, r1 = _ranks(tmp_path, 2, *TRAIN, "--preset", preset, "--max-steps", "4", "--root-dir",
                    str(tmp_path), "--run-name", f"sync_{ring}", "--no-auto-resume", "--device-replay", ring)
    assert r0["mode"] == r1["mode"] == "sync" and r0["replay_ring"] == ("device" if ring == "on" else "host")
    assert r0["steps"] == r1["steps"] == 4
    assert r0["steps_per_iteration"] == r1["steps_per_iteration"]
    assert r0["dp"]["param_checksums"] == r1["dp"]["param_checksums"]
    assert len(r0["dp"]["param_checksums"]) == r0["iterations"]
    assert r0["losses"] == r1["losses"]


def test_two_ranks_write_once_and_resume_in_one_process(tmp_path, capsys, preset):
    flags = [*TRAIN, "--preset", preset, "--fused-megastep", "--root-dir", str(tmp_path),
             "--run-name", "dp", "--no-auto-resume", "--checkpoint-freq", "2"]
    r0, r1 = _ranks(tmp_path, 2, *flags, "--max-steps", "4")
    assert [r["dp"]["rank"] for r in (r0, r1)] == [0, 1]
    assert r0["dp"]["backend"] == "gloo" and r0["dp"]["world"] == 2
    assert r0["dp"]["param_checksums"] == r1["dp"]["param_checksums"]
    assert len(r0["dp"]["param_checksums"]) == r0["megasteps"] == 2
    assert r0["losses"] == r1["losses"]
    assert r0["stats_writers"] == ["live_metrics"] and r1["stats_writers"] == []
    run = _run_dir(tmp_path, "dp")
    assert json.loads((run / "health.json").read_text())["pid"] == r0["pid"]
    steps = sorted(p.name for p in (run / "checkpoints").iterdir() if p.is_dir())
    assert steps == ["step_00000002", "step_00000004"]
    meta = json.loads((run / "checkpoints" / "step_00000004.meta.json").read_text())
    assert meta["global_step"] == 4
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    iterations = r0["warmup_chunks"] + r0["megasteps"]
    assert [r["kind"] for r in records].count("device_stats") == iterations
    # The checkpoint and rank 0's utilization records count both ranks' lanes.
    assert meta["episodes_played"] == r0["episodes"] + r1["episodes"]
    assert meta["total_simulations"] == r0["simulations"] + r1["simulations"] > r0["simulations"]
    utils = [r for r in records if r["kind"] == "util"]
    assert len(utils) == iterations - 1  # the first tick is the baseline
    for rec in utils:  # one iteration a tick; a rank's own lanes would read half
        assert rec["mesh_devices"] == 2
        assert rec["sims_per_sec"] * rec["window_s"] == pytest.approx(meta["total_simulations"] / iterations,
                                                                       rel=0.25)
    spilled = r0["buffer_size"] + r1["buffer_size"]
    # One process resumes the two ranks' run: the learner state and both shards.
    one = _in_process(capsys, *TRAIN, "--preset", preset, "--fused-megastep", "--root-dir",
                      str(tmp_path), "--run-name", "dp", "--max-steps", "6")
    assert (one["resumed_step"], one["restored_rows"], one["steps"]) == (4, spilled, 6)


def test_one_process_checkpoint_resumes_into_two_shards(tmp_path, capsys, preset):
    flags = [*TRAIN, "--preset", preset, "--fused-megastep", "--root-dir", str(tmp_path),
             "--run-name", "solo"]
    one = _in_process(capsys, *flags, "--max-steps", "2", "--no-auto-resume")
    r0, r1 = _ranks(tmp_path, 2, *flags, "--max-steps", "4")
    rows = one["buffer_size"]
    assert [r["resumed_step"] for r in (r0, r1)] == [2, 2]
    assert sorted(r["restored_rows"] for r in (r0, r1)) == [rows // 2, rows - rows // 2]
    assert r0["dp"]["param_checksums"] == r1["dp"]["param_checksums"]
    assert r0["steps"] == r1["steps"] == 4
