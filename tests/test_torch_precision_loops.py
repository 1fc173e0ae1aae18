"""The PyTorch port's training loops under a reduced
`INFERENCE_PRECISION`, against the JAX loops under the same config.

The self-play engine searches with the weights at the inference
precision (`rl/self_play.py::SelfPlayEngine._inference_variables`, the
JAX engine's `_inference_variables`): one cast copy per weights version,
shared by every stream. Both sides run a small net in float32
compute, so their forwards read the same bf16 (or dequantized int8)
weights and differ only by float rounding; the rows each chunk ingests,
the draws and the actions then agree exactly, and the n-step returns,
losses and TD errors within `test_torch_sync_loop.py`'s tolerances. A
port that searched with the float32 weights would bootstrap its returns
from other root values and fail here.

- Two synchronous iterations (the second trains two steps and syncs)
  under bfloat16 and int8: both chunks read the one cast of version 0.
- The overlapped loop, one producer stream, no weight sync, under int8:
  its harvests fold in the JAX loop's order, row for row, from one cast.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu.config import PersistenceConfig as JaxPersistence  # noqa: E402
from alphatriangle_tpu.config import TelemetryConfig  # noqa: E402
from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.rl.buffer import ExperienceBuffer as JaxBuffer  # noqa: E402
from alphatriangle_tpu.rl.self_play import SelfPlayEngine as JaxEngine  # noqa: E402
from alphatriangle_tpu.rl.trainer import Trainer as JaxTrainer  # noqa: E402
from alphatriangle_tpu.training.loop import LoopStatus as JaxStatus  # noqa: E402
from alphatriangle_tpu.training.loop import TrainingLoop as JaxLoop  # noqa: E402
from alphatriangle_tpu.training.setup import setup_training_components as jax_setup  # noqa: E402
from alphatriangle_tpu_torch.nn import precision  # noqa: E402
from alphatriangle_tpu_torch.training import (  # noqa: E402
    LoopStatus,
    TrainingLoop,
    setup_training_components,
)
from test_torch_pcr_async import _record  # noqa: E402
from test_torch_sync_loop import LOSS_RTOL, _loop_cfg  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    CPU,
    converted_state_dict,
    inject_jax_noise,
    run_root,
    small_model_config,
    torch_cfg,
)

NET_ATOL = 1e-5  # returns and policy targets of the real net (float32 compute)


def _net_cfg(env_cfg, name: str):
    """The small parity net without the transformer, in float32 compute.
    Its hidden widths of 64 keep GroupNorm's groups at 8 features, so its
    outputs depend on its weights (the conftest's tiny net, with groups
    of one feature, outputs its zero output biases whatever they are)."""
    return small_model_config(
        env_cfg, USE_TRANSFORMER=False, TRANSFORMER_LAYERS=0, INFERENCE_PRECISION=name
    )


def _assert_rows(got: dict, want: dict, n: int) -> None:
    for name, col in want.items():
        g, w = got[name][:n], col[:n]
        if name == "value_target":  # n-step returns: float sums in another order
            np.testing.assert_allclose(g, w, atol=NET_ATOL, err_msg=name)
        elif name == "other_features":
            np.testing.assert_allclose(g, w, rtol=2.5e-7, atol=0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("name", ["bfloat16", "int8"])
def test_sync_iterations_match_jax(
    monkeypatch, tmp_path, tiny_env_config, tiny_mcts_config, name
):
    """`test_torch_sync_loop.py`'s two iterations under a reduced
    inference precision: the JAX components in `_run_sync`'s order
    against the port's loop."""
    inject_jax_noise(monkeypatch)
    model_cfg = _net_cfg(tiny_env_config, name)
    jtc = _loop_cfg()
    env = JaxEnv(tiny_env_config)
    jnet = JaxNetwork(model_cfg, tiny_env_config, seed=jtc.RANDOM_SEED)
    jtrainer = JaxTrainer(jnet, jtc)
    jbuf = JaxBuffer(jtc, action_dim=tiny_env_config.action_dim)
    jeng = JaxEngine(
        env, get_feature_extractor(env, model_cfg), jnet, tiny_mcts_config, jtc,
        seed=jtc.RANDOM_SEED + 1,
    )
    c = setup_training_components(
        torch_cfg(jtc), torch_cfg(tiny_env_config), torch_cfg(model_cfg),
        torch_cfg(tiny_mcts_config), persistence_config=run_root(tmp_path), device=CPU,
    )
    state = converted_state_dict(jnet)
    c.net.model.load_state_dict(state)  # before any chunk: version 0 on both sides
    c.trainer.model.load_state_dict(state)
    loop = TrainingLoop(c)
    sampled, real_sample = [], c.buffer.sample
    c.buffer.sample = lambda *a, **kw: sampled.append(real_sample(*a, **kw)) or sampled[-1]
    casts = precision.InferenceNet.casts

    jsteps = 0
    for it in range(2):
        result = jeng.play_moves(jtc.ROLLOUT_CHUNK_MOVES)
        jbuf.add_dense(
            result.grid, result.other_features, result.policy_target, result.value_target,
            policy_weight=result.policy_weight,
        )
        want_samples, want_metrics = [], []
        for _ in range(max(1, round(result.num_experiences / jtc.BATCH_SIZE))):
            s = jbuf.sample(jtc.BATCH_SIZE, current_train_step=jtrainer.global_step)
            if s is None:
                break
            metrics, td = jtrainer.train_step(s["batch"])
            jbuf.update_priorities(s["indices"], td)
            jsteps += 1
            if jsteps % jtc.WORKER_UPDATE_FREQ_STEPS == 0:
                jtrainer.sync_to_network()
            want_samples.append(s)
            want_metrics.append(metrics)

        sampled.clear()
        added = loop._process_rollout()
        ran = loop._run_training_steps(max(1, round(added / jtc.BATCH_SIZE)))
        got_samples = [s for s in sampled if s is not None]
        assert added == result.num_experiences > 0 and ran == len(want_metrics)
        # Both chunks ran before the sync at step 2: one version, one cast.
        assert c.self_play.mcts.model.precision == name
        assert precision.InferenceNet.casts == casts + 1
        _assert_rows(c.buffer._storage, jbuf._storage, len(jbuf))
        for got, want in zip(got_samples, want_samples):
            np.testing.assert_array_equal(got["indices"], want["indices"])
        for m, jm in zip(loop.metrics[len(loop.metrics) - ran:], want_metrics):
            for key, ref in jm.items():
                np.testing.assert_allclose(m[key], ref, rtol=LOSS_RTOL, err_msg=key)
    assert loop.global_step == jsteps == 2 and c.net.weights_version == jnet.weights_version == 1


def test_async_int8_matches_jax(monkeypatch, tmp_path, tiny_env_config, tiny_mcts_config):
    """The overlapped loop under int8, one producer and no weight sync
    (as `test_torch_pcr_async.py` runs it): the same harvests in the
    same order, every chunk from the one cast of version 0."""
    inject_jax_noise(monkeypatch)
    model_cfg = _net_cfg(tiny_env_config, "int8")
    jtc = JaxTrainConfig(
        RUN_NAME="async_int8", AUTO_RESUME_LATEST=False, MAX_TRAINING_STEPS=4,
        SELF_PLAY_BATCH_SIZE=4, ROLLOUT_CHUNK_MOVES=4, BATCH_SIZE=8, BUFFER_CAPACITY=2000,
        MIN_BUFFER_SIZE_TO_TRAIN=16, USE_PER=True, PER_BETA_ANNEAL_STEPS=8, N_STEP_RETURNS=2,
        MAX_EPISODE_MOVES=30, RANDOM_SEED=5, ASYNC_ROLLOUTS=True, NUM_SELF_PLAY_WORKERS=1,
        REPLAY_RATIO=1.0, ASYNC_CHUNK_SECONDS=None, WORKER_UPDATE_FREQ_STEPS=100,
        CHECKPOINT_SAVE_FREQ_STEPS=100,
    )
    jc = jax_setup(
        train_config=jtc, env_config=tiny_env_config, model_config=model_cfg,
        mcts_config=tiny_mcts_config,
        persistence_config=JaxPersistence(ROOT_DATA_DIR=str(tmp_path / "jax"), RUN_NAME="a"),
        telemetry_config=TelemetryConfig(ENABLED=False), use_tensorboard=False,
    )
    c = setup_training_components(
        torch_cfg(jtc), torch_cfg(tiny_env_config), torch_cfg(model_cfg),
        torch_cfg(tiny_mcts_config), persistence_config=run_root(tmp_path / "port"), device=CPU,
    )
    state = converted_state_dict(jc.net)
    c.net.model.load_state_dict(state)
    c.trainer.model.load_state_dict(state)
    jloop, loop = JaxLoop(jc), TrainingLoop(c)
    jfolds, _ = _record(jloop, lambda t: None)
    folds, _ = _record(loop, lambda t: None)
    casts = precision.InferenceNet.casts
    assert jloop.run() == JaxStatus.COMPLETED
    assert loop.run() == LoopStatus.COMPLETED
    assert loop.global_step == jloop.global_step == 4
    assert loop.weight_updates == jloop.weight_updates == 0
    # Every chunk of the run (the tuning measurement's too) read one copy.
    assert precision.InferenceNet.casts == casts + 1
    n = min(len(folds), len(jfolds))
    assert n >= 2
    for (result, _), (jresult, _) in zip(folds[:n], jfolds[:n]):
        assert result.num_experiences == jresult.num_experiences
        got = {"grid": result.grid, "other_features": result.other_features,
               "policy_target": result.policy_target, "value_target": result.value_target}
        want = {"grid": jresult.grid, "other_features": jresult.other_features,
                "policy_target": jresult.policy_target, "value_target": jresult.value_target}
        _assert_rows({k: np.asarray(v) for k, v in got.items()},
                     {k: np.asarray(v) for k, v in want.items()}, result.num_experiences)
        assert list(result.episode_lengths) == list(jresult.episode_lengths)
    jc.stats.close()
    c.stats.close()
