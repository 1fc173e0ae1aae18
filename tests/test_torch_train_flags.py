"""The `cli train` and `cli league` flags of the port's telemetry slice,
on the CPU at the tiny board and net (a tuned-preset artifact):

- `--no-per` (`USE_PER=False`, as the JAX flag sets it) reaches the
  ring, the megastep runner and the loop in each loop mode, and every
  draw takes the uniform branch with all weights 1. The uniform draws
  equal the JAX ring's for the same seed and rows (the host ring and
  the device ring share the host draw), and the megastep's equals the
  JAX megastep's formula, floor(u * size), for the same key.
- `--no-telemetry` writes no `health.json`, `metrics.jsonl` or
  `flight.jsonl` and the run completes; `--watchdog-deadline` reaches
  the heartbeat and the watchdog; `--log-level` sets the root logger;
  `cli league --no-telemetry` writes none of the three files either.
"""

import json
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.rl.buffer import ExperienceBuffer as JaxBuffer  # noqa: E402
from alphatriangle_tpu.rl.device_buffer import DeviceReplayBuffer as JaxRing  # noqa: E402
from alphatriangle_tpu_torch import cli, rng, training  # noqa: E402
from alphatriangle_tpu_torch.rl import DeviceReplayBuffer  # noqa: E402
from alphatriangle_tpu_torch.rl.buffer import ExperienceBuffer  # noqa: E402
from alphatriangle_tpu_torch.rl.megastep import MegastepRunner  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import CPU, dense_rows, jax_key, tiny_preset, torch_cfg  # noqa: E402

MODES = {
    "sync": [],
    "async": ["--async-rollouts", "--workers", "2"],
    "megastep": ["--fused-megastep", "--fused-learner-steps", "2"],
}
TELEMETRY_FILES = ("health.json", "metrics.jsonl", "flight.jsonl")


@pytest.fixture
def restore_logging():
    """`cli train` configures the root logger; put it back afterwards."""
    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    yield
    for h in list(root.handlers):
        root.removeHandler(h)
    for h in handlers:
        root.addHandler(h)
    root.setLevel(level)


@pytest.fixture
def train_cli(tmp_path, tiny_env_config, tiny_model_config, monkeypatch, capsys, restore_logging):
    """Run `cli train` at the tiny preset; returns (exit code, report,
    the finished loop, the run directory)."""
    preset = tiny_preset(tmp_path / "tiny.json", tiny_env_config, tiny_model_config)
    loops = []
    real = training.run_training

    def capture(*args, **kwargs):
        loops.append(real(*args, **kwargs))
        return loops[-1]

    monkeypatch.setattr(training, "run_training", capture)

    def run(*flags, run_name="run"):
        loops.clear()
        rc = cli.main([
            "train", "--preset", preset, "--device", "cpu", "--root-dir", str(tmp_path / "runs"),
            "--run-name", run_name, "--no-auto-resume", "--no-tensorboard", "--max-steps", "2",
            "--self-play-batch", "2", "--batch-size", "4", "--min-buffer", "4",
            "--buffer-capacity", "64", "--rollout-chunk", "4", *flags,
        ])
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        loop = loops[-1]
        return rc, report, loop, loop.c.persistence_config.get_run_base_dir()

    return run


@pytest.mark.parametrize("mode", sorted(MODES))
def test_no_per_samples_uniformly(train_cli, monkeypatch, mode):
    draws = []
    for cls in (ExperienceBuffer, DeviceReplayBuffer):
        real_sample = cls.sample

        def sample(self, *a, _real=real_sample, **kw):
            out = _real(self, *a, **kw)
            if out is not None:
                draws.append(np.asarray(out["weights"]))
            return out

        monkeypatch.setattr(cls, "sample", sample)
    real_draw = MegastepRunner._sample_indices

    def draw(self, *a, **kw):
        idx, weights = real_draw(self, *a, **kw)
        draws.append(weights.cpu().numpy())
        return idx, weights

    monkeypatch.setattr(MegastepRunner, "_sample_indices", draw)
    rc, report, loop, _ = train_cli("--no-per", *MODES[mode])
    assert rc == 0 and report["status"] == "completed" and report["mode"] == mode
    c = loop.c
    assert c.train_config.USE_PER is False and loop.cfg.USE_PER is False
    assert c.buffer.use_per is False and c.buffer.tree is None
    if mode == "megastep":
        assert c.megastep.use_per is False and c.megastep.dispatch_count >= 1
    assert all("per_beta" not in m for m in loop.metrics)
    assert c.stats.get_series("PER/Beta") == []
    assert draws and sum(w.size for w in draws) >= 4
    for w in draws:
        np.testing.assert_array_equal(w, np.ones_like(w))


@pytest.mark.parametrize("ring", ["host", "device"])
def test_uniform_draw_matches_the_jax_ring(ring):
    """The same rows into the port's ring and the JAX one without PER:
    the same slots for the same seed, every weight 1."""
    grid, other, actions = (1, 3, 4), 5, 12
    jcfg = JaxTrainConfig(
        BATCH_SIZE=4, BUFFER_CAPACITY=24, MIN_BUFFER_SIZE_TO_TRAIN=8, USE_PER=False,
        AUTO_RESUME_LATEST=False, RUN_NAME="uniform", RANDOM_SEED=11,
    )
    if ring == "host":
        ours, ref = ExperienceBuffer(torch_cfg(jcfg)), JaxBuffer(jcfg, action_dim=actions)
    else:
        ours = DeviceReplayBuffer(
            torch_cfg(jcfg), grid_shape=grid, other_dim=other, action_dim=actions, device=CPU
        )
        ref = JaxRing(jcfg, grid_shape=grid, other_dim=other, action_dim=actions)
    rows = dense_rows(3, 30, grid, other, actions)
    ours.add_dense(**rows)
    ref.add_dense(**rows)
    assert ours.tree is None and ref.tree is None and len(ours) == len(ref) == 24
    for _ in range(3):
        got, want = ours.sample(4), ref.sample(4)
        np.testing.assert_array_equal(got["indices"], want["indices"])
        np.testing.assert_array_equal(got["weights"], np.ones(4, np.float32))
        np.testing.assert_array_equal(np.asarray(want["weights"]), got["weights"])


@pytest.mark.parametrize("size", [1, 7, 24])
def test_megastep_uniform_draw_matches_jax(size):
    """The megastep's uniform branch against the JAX megastep's
    `floor(u * size)` clipped to the filled slots, for the same key."""
    k, b = 3, 4
    runner = MegastepRunner.__new__(MegastepRunner)
    runner.batch_size, runner.use_per, runner.device = b, False, torch.device(CPU)
    key = rng.PRNGKey(5)
    runner.trainer = type("T", (), {})()
    runner.trainer.state = type("S", (), {"rng": key})()
    idx, weights = runner._sample_indices(None, torch.tensor(size), k)
    _, k_sample = jax.random.split(jax_key(key))
    u = jax.random.uniform(k_sample, (k, b))
    want = jnp.clip(jnp.floor(u * jnp.float32(size)).astype(jnp.int32), 0, max(size - 1, 0))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    np.testing.assert_array_equal(weights.numpy(), np.ones((k, b), np.float32))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_no_telemetry_writes_no_files(train_cli, mode):
    rc, report, loop, run_dir = train_cli("--no-telemetry", *MODES[mode])
    assert rc == 0 and report["status"] == "completed" and report["steps"] == 2
    assert not any((run_dir / name).exists() for name in TELEMETRY_FILES)
    assert loop.telemetry.enabled is False and loop.telemetry.flight is None
    assert loop.c.self_play.flight is None and loop.c.trainer.flight is None
    # The run still checkpoints and ticks its stats.
    assert (run_dir / "live_metrics.jsonl").is_file() and loop.c.checkpoints.list_steps()


def test_telemetry_on_by_default_and_watchdog_deadline(train_cli):
    rc, report, loop, run_dir = train_cli("--watchdog-deadline", "123.5")
    assert rc == 0 and report["status"] == "completed"
    assert all((run_dir / name).is_file() for name in TELEMETRY_FILES)
    health = json.loads((run_dir / "health.json").read_text())
    assert health["watchdog_deadline_s"] == 123.5 and health["learner_step"] == 2
    assert loop.telemetry.watchdog.deadline_s == 123.5
    assert loop.c.telemetry_config.WATCHDOG_DEADLINE_S == 123.5


@pytest.mark.parametrize("level", ["WARNING", "DEBUG"])
def test_log_level_sets_the_root_logger(train_cli, capsys, level):
    rc, _, _, _ = train_cli("--log-level", level)
    assert rc == 0
    root = logging.getLogger()
    assert root.level == getattr(logging, level)
    assert any(type(h).__name__ == "_StderrHandler" for h in root.handlers)


def test_league_no_telemetry(
    tmp_path, tiny_env_config, tiny_model_config, capsys, restore_logging
):
    """A two-checkpoint pool, then `cli league --no-telemetry`: the league
    run completes its rounds and writes no heartbeat, ledger or flight
    ring; its report still names the ledger's path, as the JAX one does."""
    preset = tiny_preset(tmp_path / "tiny.json", tiny_env_config, tiny_model_config)
    common = ["--device", "cpu", "--root-dir", str(tmp_path / "runs"), "--self-play-batch", "2",
              "--batch-size", "4", "--min-buffer", "4", "--buffer-capacity", "64",
              "--rollout-chunk", "4", "--checkpoint-freq", "2"]
    assert cli.main(["train", "--preset", preset, "--run-name", "pool", "--max-steps", "2",
                     "--no-tensorboard", "--no-auto-resume", "--log-level", "WARNING", *common]) == 0
    capsys.readouterr()
    rc = cli.main(["league", "--pool-from", "pool", "--run-name", "fly", "--steps", "2", "--mix", "1.0",
                   "--slots", "4", "--games", "2", "--max-moves", "6", "--sims", "4",
                   "--promotion-games", "1", "--promotion-win-rate", "0.0", "--no-telemetry", *common])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == report["exit"] == 0 and report["status"] == "completed"
    assert report["league_rounds"] >= 1 and len(report["league_records"]) == report["league_rounds"]
    run_dir = tmp_path / "runs" / "AlphaTriangleTPUTorch" / "runs" / "fly"
    assert report["ledger"] == str(run_dir / "metrics.jsonl")
    assert (run_dir / "league.jsonl").is_file()
    assert not any((run_dir / name).exists() for name in TELEMETRY_FILES)
