"""The PyTorch port's training entry points on the CPU: the megastep
loop (`training/loop.py`) through `TrainingLoop` and `run_training`, and
`cli train` in all three loop modes. These hold the port to its own
contracts (counters, the K of the tail megastep, device priorities
against the host mirror, the restores of `LOAD_CHECKPOINT_PATH` and
`LOAD_BUFFER_PATH` and the end of a run whose restore fails);
`test_torch_megastep.py` holds a megastep against the JAX package, and
`test_torch_sync_loop.py` / `test_torch_async_loop.py` the other two
loops."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu_torch import cli  # noqa: E402
from alphatriangle_tpu_torch.config import TrainConfig  # noqa: E402
from alphatriangle_tpu_torch.training import (  # noqa: E402
    EXIT_CODES,
    LoopStatus,
    TrainingLoop,
    run_training,
    setup_training_components,
)
from test_torch_megastep import make_cfg  # noqa: E402
from test_torch_resume import MODES  # noqa: E402
from test_torch_resume import _cfg as resume_cfg  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import CPU, run_root, torch_cfg  # noqa: E402


class TestTrainEntryPoints:
    def test_loop_counts_and_priorities(
        self, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
    ):
        tc = torch_cfg(make_cfg(MAX_TRAINING_STEPS=5))
        c = setup_training_components(
            tc, torch_cfg(tiny_env_config), torch_cfg(tiny_model_config),
            torch_cfg(tiny_mcts_config), persistence_config=run_root(tmp_path), device=CPU,
        )
        params0 = [p.detach().clone() for p in c.net.model.parameters()]
        loop = TrainingLoop(c)
        assert loop.run() == LoopStatus.COMPLETED
        assert loop.global_step == 5 and len(loop.metrics) == 5
        assert loop.megastep_iterations == 3  # K = 2, 2, then the 1-step tail
        assert c.megastep.dispatch_count == 3
        assert loop.warmup_chunks == c.buffer.dispatch_count > 0
        assert loop.experiences_added == len(c.buffer) > 0
        assert all(np.isfinite(m["total_loss"]) for m in loop.metrics)
        assert any(not torch.equal(a, b) for a, b in zip(params0, c.net.model.parameters()))
        tree = c.buffer.tree
        size = len(c.buffer)
        np.testing.assert_allclose(
            c.megastep.priorities[:size].numpy(), tree.tree[np.arange(size) + tree._cap2],
            rtol=1e-4, atol=1e-6,
        )
        report = loop.report()
        assert report["steps"] == 5 and report["status"] == "completed"

    def test_unported_modes_are_refused(self, tmp_path, capsys):
        """What a run refuses now is a restore it cannot make: in every
        loop mode a missing LOAD_CHECKPOINT_PATH or LOAD_BUFFER_PATH ends
        the run as ERROR (exit 1) before any step, and writes no
        checkpoint into the run directory."""
        for kw in ({"LOAD_CHECKPOINT_PATH": "ckpt"}, {"LOAD_BUFFER_PATH": "buffer.npz"}):
            for mode in ({}, {"ASYNC_ROLLOUTS": True}, {"FUSED_MEGASTEP": True}):
                cfg = TrainConfig(
                    **kw, **mode, AUTO_RESUME_LATEST=False, RUN_NAME="refused",
                    SELF_PLAY_BATCH_SIZE=2, BATCH_SIZE=4, MIN_BUFFER_SIZE_TO_TRAIN=4,
                    BUFFER_CAPACITY=64, MAX_TRAINING_STEPS=2,
                )
                loop = run_training(cfg, persistence_config=run_root(tmp_path, "refused"), device=CPU)
                assert loop.status == LoopStatus.ERROR and EXIT_CODES[loop.status] == 1
                assert isinstance(loop.error, FileNotFoundError)
                assert loop.global_step == 0 and loop.iterations == 0 and loop.warmup_chunks == 0
                assert loop.c.checkpoints.list_steps() == []
        rc = cli.main([
            "train", "--device", "cpu", "--max-steps", "2", "--self-play-batch", "2",
            "--batch-size", "4", "--min-buffer", "4", "--buffer-capacity", "64",
            "--root-dir", str(tmp_path), "--run-name", "refused", "--no-auto-resume",
            "--load-checkpoint", str(tmp_path / "nope"), "--no-tensorboard",
        ])
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 1 and report["status"] == "error" and report["steps"] == 0

    @pytest.mark.parametrize("mode", ["sync_host", "async", "megastep"])
    def test_load_paths_restore_in_each_mode(
        self, mode, monkeypatch, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
    ):
        """LOAD_CHECKPOINT_PATH and LOAD_BUFFER_PATH restore another run's
        step directory and spill into a fresh run of each loop mode,
        which trains on from that step in its own directory."""
        configs = (torch_cfg(tiny_env_config), torch_cfg(tiny_model_config), torch_cfg(tiny_mcts_config))
        src = run_training(
            torch_cfg(resume_cfg("src", 4, AUTO_RESUME_LATEST=False, **MODES["sync_host"])),
            *configs, persistence_config=run_root(tmp_path, "src"), device=CPU,
        )
        step_dir = src.c.persistence_config.get_checkpoint_dir() / "step_00000004"
        spill = src.c.persistence_config.get_buffer_dir() / "buffer_00000004.npz"
        want = src.c.checkpoints.restore_path(step_dir).train_state
        seen = {}
        real_run = TrainingLoop.run

        def run(loop):
            seen["state"] = loop.c.trainer.get_state()
            seen["size"] = len(loop.c.buffer)
            return real_run(loop)

        monkeypatch.setattr(TrainingLoop, "run", run)
        cfg = resume_cfg(
            "dst", 6, AUTO_RESUME_LATEST=False, LOAD_CHECKPOINT_PATH=str(step_dir),
            LOAD_BUFFER_PATH=str(spill), **MODES[mode],
        )
        loop = run_training(
            torch_cfg(cfg), *configs, persistence_config=run_root(tmp_path, "dst"), device=CPU
        )
        assert loop.status == LoopStatus.COMPLETED and loop.resumed_step == 4
        assert loop.c.persistence_config.RUN_NAME == "dst"
        assert seen["size"] == len(src.c.buffer)
        for name, t in want["params"].items():
            assert torch.equal(seen["state"]["params"][name], t), name
        assert seen["state"]["step"] == 4 and loop.global_step == 6
        assert loop.c.checkpoints.valid_steps() == [6]

    def test_cli_train_on_the_cpu(self, tmp_path, capsys):
        rc = cli.main([
            "train", "--device", "cpu", "--fused-megastep", "--max-steps", "2",
            "--self-play-batch", "2", "--batch-size", "4", "--min-buffer", "4",
            "--buffer-capacity", "64", "--rollout-chunk", "7", "--fused-learner-steps", "2",
            "--seed", "1", "--root-dir", str(tmp_path), "--no-tensorboard",
        ])
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0
        assert report["steps"] == 2 and report["megasteps"] == 1
        assert report["rows_ingested"] >= 4 and report["device"] == "cpu"
        assert all(np.isfinite(report["losses"]["total_loss"]))

    @pytest.mark.parametrize("mode", [[], ["--async-rollouts", "--workers", "2"]])
    def test_cli_train_runs_the_other_loops(self, tmp_path, capsys, mode):
        """Without a mode flag `train` runs the synchronous loop; with
        --async-rollouts, the overlapped loop. Both fold into the host
        ring on the CPU ("auto") and end at --max-steps."""
        rc = cli.main([
            "train", "--device", "cpu", *mode, "--max-steps", "3", "--self-play-batch", "2",
            "--batch-size", "4", "--min-buffer", "4", "--buffer-capacity", "64",
            "--rollout-chunk", "4", "--seed", "1", "--replay-ratio", "2.0",
            "--root-dir", str(tmp_path), "--no-tensorboard",
        ])
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and report["status"] == "completed"
        assert report["mode"] == ("async" if mode else "sync")
        assert report["replay_ring"] == "host" and report["megasteps"] == 0
        assert report["steps"] == 3 and report["rows_ingested"] == report["buffer_size"] >= 4
        assert all(np.isfinite(report["losses"]["total_loss"]))
        if mode:
            assert report["replay_ratio"] <= 2.0 and report["producer_restarts"] == 0
            assert set(report["harvests_by_stream"]) <= {"0", "1"}
        else:
            assert sum(report["steps_per_iteration"]) == 3
