"""The PyTorch port's overlapped training loop (`ASYNC_ROLLOUTS`) under
the flagship recipe's search, Gumbel roots with playout-cap
randomization, against the JAX loop.

- The tiny run of the JAX loop tests, with one producer stream, no
  weight sync during the run and chunks of the configured length (no
  auto-tune): both producers then play every chunk from the same
  weights and keys, so the harvests they fold must agree in order
  whatever the threads' timing: the `is_full` sequence and simulations
  per move bit for bit, the rows, their policy weights and the episodes
  exactly, the scalar features within one ulp, and the n-step returns
  and the Gumbel improved policy within 1e-5: both run the real net
  (the JAX weights, converted), whose logits and values each framework
  rounds its own way, and sum floats in another order. The
  rollout events each fold sends (`SelfPlay/Full_Search_Fraction`
  among them) agree the same way; the learner steps fall where each
  loop's threads put them, so the loop's own events (`Loss/*`,
  `System/Rollout_Queue_Depth`, `System/Replay_Ratio_Actual`) are held
  by name, by their steps' order and by their bounds.
- `cli train --preset 3 --async-rollouts` at the preset's widths, two
  lanes deep, runs on the CPU and reports the same events.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu.config import AlphaTriangleMCTSConfig as JaxMCTSConfig  # noqa: E402
from alphatriangle_tpu.config import PersistenceConfig as JaxPersistence  # noqa: E402
from alphatriangle_tpu.config import TelemetryConfig  # noqa: E402
from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.training.loop import LoopStatus as JaxStatus  # noqa: E402
from alphatriangle_tpu.training.loop import TrainingLoop as JaxLoop  # noqa: E402
from alphatriangle_tpu.training.setup import setup_training_components as jax_setup  # noqa: E402
from alphatriangle_tpu_torch import cli  # noqa: E402
from alphatriangle_tpu_torch.training import LoopStatus, TrainingLoop, setup_training_components  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    CPU,
    converted_state_dict,
    inject_jax_noise,
    run_root,
    torch_cfg,
)

NET_ATOL = 1e-5  # returns, values and the improved policy of the real net
ULP_RTOL = 2.5e-7  # one float32 ulp: XLA's rewrite of a feature's divisions
STEPS = 4
# Rollout events: one set per fold, from the harvest alone.
FOLD_EVENTS = (
    "Buffer/Size", "SelfPlay/Experiences_Per_Chunk", "SelfPlay/Wasted_Slot_Fraction",
    "SelfPlay/Step_Reward", "SelfPlay/Root_Value", "SelfPlay/Full_Search_Fraction",
)
LOOP_EVENTS = (
    "Loss/total_loss", "LearningRate", "Loss/Grad_Norm", "PER/Beta",
    "System/Rollout_Queue_Depth", "System/Replay_Ratio_Actual",
)


def _record(loop, trace_of) -> tuple[list, list]:
    """Wrap the loop's fold and its collector's ingestion: the
    (harvest, trace) of every fold, and every raw event."""
    folds, events = [], []
    fold, log_event = loop._fold_result, loop.c.stats.log_event

    def record_fold(result, trace=None, *args, **kw):
        folds.append((result, trace_of(trace)))
        return fold(result, trace, *args, **kw)

    def record_event(event):
        events.append((event.name, float(event.value), event.global_step))
        return log_event(event)

    loop._fold_result = record_fold
    loop.c.stats.log_event = record_event
    return folds, events


def _trace(trace) -> dict:
    return {k: np.asarray(trace[k]) for k in ("is_full", "sims", "reward", "root_value")}


def _assert_harvest(got, want) -> None:
    (result, trace), (jresult, jtrace) = got, want
    np.testing.assert_array_equal(trace["is_full"], jtrace["is_full"])
    np.testing.assert_array_equal(trace["sims"], jtrace["sims"])
    np.testing.assert_array_equal(trace["reward"], jtrace["reward"])
    np.testing.assert_allclose(trace["root_value"], jtrace["root_value"], atol=NET_ATOL)
    assert result.num_experiences == jresult.num_experiences
    for field in ("grid", "policy_weight"):
        np.testing.assert_array_equal(np.asarray(getattr(result, field)), np.asarray(getattr(jresult, field)))
    np.testing.assert_allclose(
        np.asarray(result.other_features), np.asarray(jresult.other_features), rtol=ULP_RTOL, atol=0
    )
    np.testing.assert_allclose(
        np.asarray(result.policy_target), np.asarray(jresult.policy_target), atol=NET_ATOL
    )
    np.testing.assert_allclose(
        np.asarray(result.value_target), np.asarray(jresult.value_target), atol=NET_ATOL
    )
    assert (result.num_episodes, list(result.episode_lengths)) == (
        jresult.num_episodes, list(jresult.episode_lengths)
    )
    np.testing.assert_allclose(result.episode_scores, jresult.episode_scores, atol=NET_ATOL)


def _by_name(events: list, name: str) -> list:
    return [(v, s) for n, v, s in events if n == name]


def test_async_gumbel_pcr_matches_jax(
    monkeypatch, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
):
    inject_jax_noise(monkeypatch)
    jtc = JaxTrainConfig(
        RUN_NAME="async_pcr", AUTO_RESUME_LATEST=False, MAX_TRAINING_STEPS=STEPS,
        SELF_PLAY_BATCH_SIZE=4, ROLLOUT_CHUNK_MOVES=4, BATCH_SIZE=8, BUFFER_CAPACITY=2000,
        MIN_BUFFER_SIZE_TO_TRAIN=16, USE_PER=True, PER_BETA_ANNEAL_STEPS=8, N_STEP_RETURNS=2,
        MAX_EPISODE_MOVES=30, RANDOM_SEED=5, ASYNC_ROLLOUTS=True, NUM_SELF_PLAY_WORKERS=1,
        REPLAY_RATIO=1.0, ASYNC_CHUNK_SECONDS=None, WORKER_UPDATE_FREQ_STEPS=100,
        CHECKPOINT_SAVE_FREQ_STEPS=100,
    )
    jmc = JaxMCTSConfig(**{
        **tiny_mcts_config.model_dump(), "root_selection": "gumbel", "fast_simulations": 4,
        "full_search_prob": 0.5,
    })
    jc = jax_setup(
        train_config=jtc, env_config=tiny_env_config, model_config=tiny_model_config,
        mcts_config=jmc,
        persistence_config=JaxPersistence(ROOT_DATA_DIR=str(tmp_path / "jax"), RUN_NAME="a"),
        telemetry_config=TelemetryConfig(ENABLED=False), use_tensorboard=False,
    )
    c = setup_training_components(
        torch_cfg(jtc), torch_cfg(tiny_env_config), torch_cfg(tiny_model_config),
        torch_cfg(jmc), persistence_config=run_root(tmp_path / "port"), device=CPU,
    )
    state = converted_state_dict(jc.net)
    c.net.model.load_state_dict(state)
    c.trainer.model.load_state_dict(state)
    assert c.self_play.use_gumbel and c.self_play.mcts_fast.exploit
    jloop, loop = JaxLoop(jc), TrainingLoop(c)
    jfolds, jevents = _record(jloop, lambda t: _trace(t if t is not None else jc.self_play.last_trace))
    folds, events = _record(loop, lambda t: _trace(t if t is not None else c.self_play.last_trace))
    assert jloop.run() == JaxStatus.COMPLETED
    assert loop.run() == LoopStatus.COMPLETED
    assert loop.global_step == jloop.global_step == STEPS
    assert loop.weight_updates == jloop.weight_updates == 0
    # The gate asks for STEPS * BATCH_SIZE rows past a 16-row warm-up.
    n = min(len(folds), len(jfolds))
    assert n >= 2
    for got, want in zip(folds[:n], jfolds[:n]):
        _assert_harvest(got, want)
    is_full = np.concatenate([t["is_full"] for _, t in folds[:n]])
    assert 0 < is_full.sum() < is_full.size  # both kinds of move
    for name in FOLD_EVENTS:
        got, want = _by_name(events, name)[:n], _by_name(jevents, name)[:n]
        assert len(got) == len(want) == n, name
        np.testing.assert_allclose([v for v, _ in got], [v for v, _ in want], atol=NET_ATOL,
                                   err_msg=name)
    np.testing.assert_array_equal(
        [v for v, _ in _by_name(events, "SelfPlay/Full_Search_Fraction")[:n]],
        [t["is_full"].mean() for _, t in folds[:n]],
    )
    for name in LOOP_EVENTS:
        assert _by_name(events, name) and _by_name(jevents, name), name
    for evs in (events, jevents):
        steps = [s for _, s in _by_name(evs, "Loss/total_loss")]
        assert steps == list(range(1, STEPS + 1))
        ticks = [s for _, s in _by_name(evs, "System/Rollout_Queue_Depth")]
        assert ticks == sorted(ticks) and ticks[-1] <= STEPS
        assert all(0.0 <= v <= 1.0 for v, _ in _by_name(evs, "System/Replay_Ratio_Actual"))
    assert {n for n, _, _ in events} == {n for n, _, _ in jevents}
    jc.stats.close()
    c.stats.close()


def test_cli_train_preset3_async_on_the_cpu(tmp_path, capsys):
    """Preset 3's recipe at its widths in the overlapped loop, two lanes
    deep: one producer stream, two learner steps."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rc = cli.main([
            "train", "--preset", "3", "--async-rollouts", "--device", "cpu", "--root-dir",
            str(tmp_path), "--max-steps", "2", "--self-play-batch", "2", "--batch-size", "4",
            "--min-buffer", "4", "--buffer-capacity", "64", "--rollout-chunk", "4",
            "--fused-learner-steps", "1", "--no-auto-resume", "--no-tensorboard",
        ])
    finally:
        torch.set_num_threads(before)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and report["status"] == "completed" and report["mode"] == "async"
    assert report["steps"] == 2 and report["device"] == "cpu"
    means = [json.loads(line)["means"] for line in open(report["live_metrics"])]
    names = set().union(*means)
    assert {"SelfPlay/Full_Search_Fraction", "System/Rollout_Queue_Depth",
            "System/Replay_Ratio_Actual", "Loss/total_loss"} <= names
    assert all(0.0 <= m["SelfPlay/Full_Search_Fraction"] <= 1.0
               for m in means if "SelfPlay/Full_Search_Fraction" in m)
