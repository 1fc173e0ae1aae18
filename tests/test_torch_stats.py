"""Parity of the PyTorch port's stats plane (`stats/collector.py`,
`stats/events.py`, the training loop's events) with the JAX package.

- The `StatsCollector` contract: the same events into both collectors
  give the same tick means, series, latest values, non-finite drop
  counts and `live_metrics.jsonl` lines (all but the wall-clock time);
  `close()` flushes what is pending at the newest step seen. The
  TensorBoard writer is exercised through a stand-in `SummaryWriter`.
- Two synchronous iterations of the JAX `TrainingLoop` and the port's,
  from the same weights, configs and seeds, send the same events: the
  same names at the same steps, with values within the learner
  tolerance (1e-4 relative: losses and gradient norms sum in another
  order; n-step returns within 1e-5).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu.config import PersistenceConfig as JaxPersistence  # noqa: E402
from alphatriangle_tpu.config import TelemetryConfig  # noqa: E402
from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.stats.collector import StatsCollector as JaxCollector  # noqa: E402
from alphatriangle_tpu.stats.events import RawMetricEvent as JaxEvent  # noqa: E402
from alphatriangle_tpu.training.loop import TrainingLoop as JaxLoop  # noqa: E402
from alphatriangle_tpu.training.setup import setup_training_components as jax_setup  # noqa: E402
from alphatriangle_tpu_torch.stats import RawMetricEvent, StatsCollector  # noqa: E402
from alphatriangle_tpu_torch.stats import collector as collector_mod  # noqa: E402
from alphatriangle_tpu_torch.training import TrainingLoop, setup_training_components  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    CPU,
    converted_state_dict,
    inject_jax_noise,
    run_root,
    torch_cfg,
)

LOSS_RTOL = 1e-4

EVENTS = [
    ("Loss/total_loss", 1.5, 1),
    ("Loss/total_loss", 2.5, 2),
    ("Buffer/Size", 10, 2),
    ("Loss/total_loss", float("nan"), 2),
    ("SelfPlay/Root_Value", float("inf"), 2),
    ("LearningRate", 1e-3, 2),
]


def _live_lines(path) -> list[dict]:
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    for line in lines:
        assert isinstance(line.pop("time"), float)
    return lines


def _collectors(tmp_path):
    jc = JaxCollector(
        JaxPersistence(ROOT_DATA_DIR=str(tmp_path / "jax"), RUN_NAME="s"), use_tensorboard=False
    )
    tc = StatsCollector(run_root(tmp_path / "port", "s"), use_tensorboard=False)
    return jc, tc


class TestCollector:
    def test_contract_matches_jax(self, tmp_path):
        jc, tc = _collectors(tmp_path)
        for name, value, step in EVENTS:
            jc.log_event(JaxEvent(name=name, value=value, global_step=step))
        tc.log_batch_events([RawMetricEvent(name, value, step) for name, value, step in EVENTS])
        want, got = jc.process_and_log(2), tc.process_and_log(2)
        assert got == want and got["Loss/total_loss"] == 2.0
        assert got["Stats/nonfinite_dropped"] == 2.0
        assert tc.nonfinite_dropped() == jc.nonfinite_dropped()
        jc.log_scalar("Buffer/Size", 12, 3)
        tc.log_scalar("Buffer/Size", 12, 3)
        assert tc.process_and_log(3) == jc.process_and_log(3)
        # Pending at close: flushed at the newest step seen.
        jc.log_scalar("Buffer/Size", 20, 7)
        tc.log_scalar("Buffer/Size", 20, 7)
        jc.close()
        tc.close()
        tc.close()  # idempotent
        for name in ("Loss/total_loss", "Buffer/Size", "LearningRate", "Stats/nonfinite_dropped"):
            assert tc.get_series(name) == jc.get_series(name), name
            assert tc.latest(name) == jc.latest(name)
        assert tc.get_series("SelfPlay/Root_Value") == [] and tc.latest("nope") is None
        jpath = JaxPersistence(ROOT_DATA_DIR=str(tmp_path / "jax"), RUN_NAME="s").get_run_base_dir()
        assert tc.live_path.name == "live_metrics.jsonl"
        assert _live_lines(tc.live_path) == _live_lines(jpath / "live_metrics.jsonl")
        assert tc.writers == ["live_metrics"]

    def test_history_limit_and_no_live_file(self, monkeypatch):
        """The series keep the newest HISTORY_LIMIT means; a collector
        with no run directory opens no writer."""
        assert collector_mod.HISTORY_LIMIT == 1024
        monkeypatch.setattr(collector_mod, "HISTORY_LIMIT", 2)
        tc = StatsCollector(None)
        for step in range(4):
            tc.log_scalar("x", step, step)
            tc.process_and_log(step)
        assert tc.get_series("x") == [(2, 2.0), (3, 3.0)]
        assert tc.writers == [] and tc.live_path is None
        tc.close()

    def test_tensorboard_writer_when_it_imports(self, tmp_path, monkeypatch):
        calls = []

        class Writer:
            def __init__(self, logdir):
                calls.append(("init", logdir))

            def add_scalar(self, name, value, step):
                calls.append(("scalar", name, value, step))

            def add_text(self, name, text, step):
                calls.append(("text", name, step))

            def flush(self):
                pass

            def close(self):
                calls.append(("close",))

        monkeypatch.setattr(collector_mod, "summary_writer_cls", lambda: Writer)
        persistence = run_root(tmp_path)
        tc = StatsCollector(persistence)
        assert tc.writers == ["live_metrics", "tensorboard"]
        assert calls[0] == ("init", str(persistence.get_tensorboard_dir()))
        tc.log_params({"train": torch_cfg(JaxTrainConfig(RUN_NAME="x"))})
        tc.log_scalar("Loss/total_loss", 3.0, 4)
        tc.process_and_log(4)
        tc.close()
        assert ("text", "config/train", 0) in calls
        assert ("scalar", "Loss/total_loss", 3.0, 4) in calls and calls[-1] == ("close",)
        # No TensorBoard package: the live file alone.
        monkeypatch.setattr(collector_mod, "summary_writer_cls", lambda: None)
        bare = StatsCollector(run_root(tmp_path, "b"))
        assert bare.writers == ["live_metrics"]
        bare.close()


def _loop_cfg() -> JaxTrainConfig:
    """The JAX loop tests' tiny run (tests/test_training_loop.py)."""
    return JaxTrainConfig(
        RUN_NAME="stats_parity", AUTO_RESUME_LATEST=False, MAX_TRAINING_STEPS=8,
        SELF_PLAY_BATCH_SIZE=4, ROLLOUT_CHUNK_MOVES=4, BATCH_SIZE=8, BUFFER_CAPACITY=2000,
        MIN_BUFFER_SIZE_TO_TRAIN=16, USE_PER=True, PER_BETA_ANNEAL_STEPS=8, N_STEP_RETURNS=2,
        WORKER_UPDATE_FREQ_STEPS=2, CHECKPOINT_SAVE_FREQ_STEPS=4, MAX_EPISODE_MOVES=30,
        RANDOM_SEED=5,
    )


def test_sync_iteration_events_match_jax(
    monkeypatch, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
):
    """Two synchronous iterations, each a rollout chunk, its learner steps
    and a tick: the first leaves the ring short of a batch, the second
    trains two steps and syncs the weights at step 2."""
    inject_jax_noise(monkeypatch)
    jtc = _loop_cfg()
    jc = jax_setup(
        train_config=jtc, env_config=tiny_env_config, model_config=tiny_model_config,
        mcts_config=tiny_mcts_config,
        persistence_config=JaxPersistence(ROOT_DATA_DIR=str(tmp_path / "jax"), RUN_NAME="s"),
        telemetry_config=TelemetryConfig(ENABLED=False), use_tensorboard=False,
    )
    c = setup_training_components(
        torch_cfg(jtc), torch_cfg(tiny_env_config), torch_cfg(tiny_model_config),
        torch_cfg(tiny_mcts_config), persistence_config=run_root(tmp_path / "port"), device=CPU,
    )
    state = converted_state_dict(jc.net)
    c.net.model.load_state_dict(state)
    c.trainer.model.load_state_dict(state)
    jloop, loop = JaxLoop(jc), TrainingLoop(c)
    for _ in range(2):
        for lp in (jloop, loop):
            added = lp._process_rollout()
            lp._run_training_steps(max(1, round(added / jtc.BATCH_SIZE)))
            lp.c.stats.process_and_log(lp.global_step)
    assert loop.global_step == jloop.global_step == 2
    ours = {name for name in c.stats._history}
    theirs = {name for name in jc.stats._history}
    assert ours == theirs
    assert {"Loss/total_loss", "LearningRate", "PER/Beta", "Buffer/Size",
            "SelfPlay/Wasted_Slot_Fraction", "Progress/Weight_Updates_Total"} <= ours
    for name in sorted(theirs):
        got, want = c.stats.get_series(name), jc.stats.get_series(name)
        assert [s for s, _ in got] == [s for s, _ in want], name
        np.testing.assert_allclose(
            [v for _, v in got], [v for _, v in want], rtol=LOSS_RTOL, atol=1e-5, err_msg=name
        )
    jc.stats.close()
    c.stats.close()
