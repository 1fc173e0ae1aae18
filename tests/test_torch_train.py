"""The PyTorch port's training entry points on the CPU: the megastep
loop (`training/loop.py`) through `TrainingLoop` and `run_training`, and
`cli train` in all three loop modes. These hold the port to its own
contracts (counters, the K of the tail megastep, device priorities
against the host mirror, the refusal of restores);
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
    LoopStatus,
    TrainingLoop,
    run_training,
    setup_training_components,
)
from test_torch_megastep import make_cfg  # noqa: E402
from torch_parity import CPU, torch_cfg  # noqa: E402


class TestTrainEntryPoints:
    def test_loop_counts_and_priorities(self, tiny_env_config, tiny_model_config, tiny_mcts_config):
        tc = torch_cfg(make_cfg(MAX_TRAINING_STEPS=5))
        c = setup_training_components(
            tc, torch_cfg(tiny_env_config), torch_cfg(tiny_model_config),
            torch_cfg(tiny_mcts_config), device=CPU,
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

    def test_unported_modes_are_refused(self):
        # Every loop mode runs; the restores wait for the checkpoint slice.
        for kw in ({"LOAD_CHECKPOINT_PATH": "ckpt"}, {"LOAD_BUFFER_PATH": "buffer"}):
            for mode in ({}, {"ASYNC_ROLLOUTS": True}, {"FUSED_MEGASTEP": True}):
                with pytest.raises(ValueError, match="restore are not ported"):
                    run_training(TrainConfig(**kw, **mode), device=CPU)

    def test_cli_train_on_the_cpu(self, capsys):
        rc = cli.main([
            "train", "--device", "cpu", "--fused-megastep", "--max-steps", "2",
            "--self-play-batch", "2", "--batch-size", "4", "--min-buffer", "4",
            "--buffer-capacity", "64", "--rollout-chunk", "7", "--fused-learner-steps", "2",
            "--seed", "1",
        ])
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0
        assert report["steps"] == 2 and report["megasteps"] == 1
        assert report["rows_ingested"] >= 4 and report["device"] == "cpu"
        assert all(np.isfinite(report["losses"]["total_loss"]))

    @pytest.mark.parametrize("mode", [[], ["--async-rollouts", "--workers", "2"]])
    def test_cli_train_runs_the_other_loops(self, capsys, mode):
        """Without a mode flag `train` runs the synchronous loop; with
        --async-rollouts, the overlapped loop. Both fold into the host
        ring on the CPU ("auto") and end at --max-steps."""
        rc = cli.main([
            "train", "--device", "cpu", *mode, "--max-steps", "3", "--self-play-batch", "2",
            "--batch-size", "4", "--min-buffer", "4", "--buffer-capacity", "64",
            "--rollout-chunk", "4", "--seed", "1", "--replay-ratio", "2.0",
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
