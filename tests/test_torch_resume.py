"""Resume of the PyTorch port's training runs (`training/runner.py`'s
auto-resume and restore, the loop's save cadences) in every loop mode,
and a synchronous resume from a JAX checkpoint against the JAX
package's resume from the same checkpoint.

A resumed run does not equal an uninterrupted one, in either package:
self-play lanes, n-step windows and the ring's sampling generator are
not in the checkpoint. What holds:

- In each mode (synchronous on the host ring and on the CPU device
  ring, overlapped, fused megastep): a run to step 4 with a checkpoint
  every 2 steps, then a run of another name auto-resumes it to step 6.
  The learner state installed before the first resumed step equals the
  step-4 file bit for bit, the ring holds the spill's rows and
  priorities exactly, the counters carry on, and the run ends with a
  checkpoint at step 6. In megastep mode the device priorities the first
  resumed megastep draws from are the float32 of the restored SumTree
  leaves.
- A JAX checkpoint carried into a port run directory
  (`train_state_from_flax` and the shared spill) resumes as the JAX
  package resumes it: two synchronous iterations with the harness and
  tolerances of `test_torch_sync_loop.py::test_iterations_match_jax`
  (rows, sampled slots and step counts exact; losses 1e-4 relative).
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu.config import PersistenceConfig as JaxPersistence  # noqa: E402
from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.rl.buffer import ExperienceBuffer as JaxBuffer  # noqa: E402
from alphatriangle_tpu.rl.self_play import SelfPlayEngine as JaxEngine  # noqa: E402
from alphatriangle_tpu.rl.trainer import Trainer as JaxTrainer  # noqa: E402
from alphatriangle_tpu.stats.persistence import CheckpointManager as JaxManager  # noqa: E402
from alphatriangle_tpu_torch.rl.megastep import MegastepRunner  # noqa: E402
from alphatriangle_tpu_torch.stats import CheckpointManager  # noqa: E402
from alphatriangle_tpu_torch.stats.persistence import load_spill  # noqa: E402
from alphatriangle_tpu_torch.training import (  # noqa: E402
    LoopStatus,
    TrainingLoop,
    run_training,
    setup_training_components,
)
from alphatriangle_tpu_torch.training.runner import _restore  # noqa: E402
from test_torch_checkpoint import _assert_state_equal, jax_train_state  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import CPU, dense_rows, inject_jax_noise, run_root, torch_cfg  # noqa: E402

LOSS_RTOL = 1e-4

MODES = {
    "sync_host": dict(DEVICE_REPLAY="off"),
    "sync_device": dict(DEVICE_REPLAY="on"),
    "async": dict(ASYNC_ROLLOUTS=True, NUM_SELF_PLAY_WORKERS=2, FUSED_LEARNER_STEPS=2),
    "megastep": dict(FUSED_MEGASTEP=True, DEVICE_REPLAY="on", FUSED_LEARNER_STEPS=2),
}


def _cfg(run: str, max_steps: int, **kw) -> JaxTrainConfig:
    """The JAX loop tests' tiny run, checkpointing every 2 steps."""
    base = dict(
        RUN_NAME=run, AUTO_RESUME_LATEST=True, MAX_TRAINING_STEPS=max_steps,
        SELF_PLAY_BATCH_SIZE=4, ROLLOUT_CHUNK_MOVES=2, BATCH_SIZE=8, BUFFER_CAPACITY=2000,
        MIN_BUFFER_SIZE_TO_TRAIN=16, USE_PER=True, PER_BETA_ANNEAL_STEPS=8, N_STEP_RETURNS=2,
        WORKER_UPDATE_FREQ_STEPS=2, CHECKPOINT_SAVE_FREQ_STEPS=2, MAX_EPISODE_MOVES=30,
        RANDOM_SEED=5,
    )
    base.update(kw)
    return JaxTrainConfig(**base)


@pytest.mark.parametrize("mode", list(MODES))
def test_auto_resume_continues_in_each_mode(
    mode, monkeypatch, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
):
    configs = (torch_cfg(tiny_env_config), torch_cfg(tiny_model_config), torch_cfg(tiny_mcts_config))
    first = run_training(
        torch_cfg(_cfg("first", 4, **MODES[mode])), *configs,
        persistence_config=run_root(tmp_path, "first"), device=CPU,
    )
    assert first.status == LoopStatus.COMPLETED and first.global_step == 4
    assert first.report()["checkpointed_step"] == 4 and first.resumed_step is None
    mgr = first.c.checkpoints
    # One save per crossed multiple of 2 (an overlapped group may cross
    # one at step 3), the last at step 4.
    assert len(mgr.valid_steps()) == 2 and mgr.valid_steps()[-1] == 4
    want_state = mgr.restore(step=4).train_state
    spill = load_spill(first.c.persistence_config.get_buffer_dir() / "buffer_00000004.npz")
    assert spill["size"] == len(first.c.buffer) > 0

    seen = {}
    real_run, real_megastep = TrainingLoop.run, MegastepRunner.run_megastep

    def run(loop):
        buf = loop.c.buffer
        seen["state"] = loop.c.trainer.get_state()
        seen["size"] = len(buf)
        seen["leaves"] = buf.tree.tree[buf.tree._cap2 :][: buf.capacity].copy()
        seen["net_equals_learner"] = all(
            torch.equal(a, b)
            for a, b in zip(loop.c.net.model.parameters(), loop.c.trainer.model.parameters())
        )
        return real_run(loop)

    def run_megastep(runner, *args, **kwargs):
        seen.setdefault("priorities", runner.priorities.clone())
        return real_megastep(runner, *args, **kwargs)

    monkeypatch.setattr(TrainingLoop, "run", run)
    monkeypatch.setattr(MegastepRunner, "run_megastep", run_megastep)
    second = run_training(
        torch_cfg(_cfg("second", 6, **MODES[mode])), *configs,
        persistence_config=run_root(tmp_path, "second"), device=CPU,
    )
    assert second.status == LoopStatus.COMPLETED
    assert second.c.persistence_config.RUN_NAME == "first" and second.resumed_step == 4
    assert second.global_step == second.c.trainer.global_step == 6
    assert second.c.checkpoints.latest_step() == 6
    assert not (tmp_path / "AlphaTriangleTPUTorch" / "runs" / "second" / "checkpoints").exists()
    _assert_state_equal(seen["state"], want_state)
    assert seen["net_equals_learner"]
    assert seen["size"] == spill["size"]
    np.testing.assert_array_equal(seen["leaves"][: spill["size"]], spill["priorities"])
    assert not seen["leaves"][spill["size"] :].any()
    assert second.episodes_played >= first.episodes_played
    assert second.total_simulations > first.total_simulations
    assert second.weight_updates >= first.weight_updates
    assert [m["step"] for m in second.metrics] == [5, 6]
    if mode == "megastep":
        assert second.megastep_iterations == 1 and second.warmup_chunks == 0
        leaves = seen["leaves"].astype(np.float32)
        np.testing.assert_array_equal(seen["priorities"][:-1].numpy(), leaves)
        assert seen["priorities"][-1] == 0
    else:
        assert first.weight_updates == 2 and second.weight_updates == 3


# --- a JAX checkpoint resumed on both sides -------------------------------------


def _jax_checkpoint(tmp_path, jtc, env_cfg, model_cfg):
    """A JAX run directory at step 2: a learner trained two steps on PER
    draws from a ring of random rows, and the ring's spill."""
    jnet = JaxNetwork(model_cfg, env_cfg, seed=jtc.RANDOM_SEED)
    jtrainer = JaxTrainer(jnet, jtc)
    jbuf = JaxBuffer(jtc, action_dim=env_cfg.action_dim)
    other = get_feature_extractor(JaxEnv(env_cfg), model_cfg).other_dim
    jbuf.add_dense(**dense_rows(0, 24, (1, env_cfg.ROWS, env_cfg.COLS), other, env_cfg.action_dim))
    for _ in range(2):
        s = jbuf.sample(jtc.BATCH_SIZE, current_train_step=jtrainer.global_step)
        _, td = jtrainer.train_step(s["batch"])
        jbuf.update_priorities(s["indices"], td)
    persistence = JaxPersistence(ROOT_DATA_DIR=str(tmp_path / "jax"), RUN_NAME="j")
    jmgr = JaxManager(persistence)
    jmgr.save(2, jtrainer.state, counters={"episodes_played": 7, "total_simulations": 99})
    jmgr.save_buffer(2, jbuf)
    jmgr.wait_until_finished()
    return jmgr, persistence


def test_resume_from_a_jax_checkpoint_matches_the_jax_resume(
    monkeypatch, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
):
    inject_jax_noise(monkeypatch)
    jtc = _cfg("conv", 8, AUTO_RESUME_LATEST=False, ROLLOUT_CHUNK_MOVES=4, CHECKPOINT_SAVE_FREQ_STEPS=4)
    jmgr, jpersistence = _jax_checkpoint(tmp_path, jtc, tiny_env_config, tiny_model_config)

    # --- the JAX package's resume (training/runner.py's restore block) ---
    env = JaxEnv(tiny_env_config)
    jnet = JaxNetwork(tiny_model_config, tiny_env_config, seed=11)
    jtrainer = JaxTrainer(jnet, jtc)
    jbuf = JaxBuffer(jtc, action_dim=tiny_env_config.action_dim)
    loaded = jmgr.restore(jtrainer.state, buffer=jbuf)
    jmgr.close()
    jtrainer.set_state(loaded.train_state)
    jtrainer.sync_to_network()
    jeng = JaxEngine(
        env, get_feature_extractor(env, tiny_model_config), jnet, tiny_mcts_config, jtc,
        seed=jtc.RANDOM_SEED + 1,
    )

    # --- carried into a port run directory, resumed by the port's runner ---
    port = run_root(tmp_path, "conv")
    CheckpointManager(port).save(2, jax_train_state(loaded.train_state), counters=loaded.counters)
    shutil.copy(
        jpersistence.get_buffer_dir() / "buffer_00000002.npz", port.get_buffer_dir() / "buffer_00000002.npz"
    )
    c = setup_training_components(
        torch_cfg(jtc), torch_cfg(tiny_env_config), torch_cfg(tiny_model_config),
        torch_cfg(tiny_mcts_config), persistence_config=port, device=CPU,
    )
    loop = TrainingLoop(c)
    _restore(loop)
    assert not c.buffer.is_device
    assert loop.global_step == jtrainer.global_step == 2 and loop.resumed_step == 2
    assert loop.episodes_played == 7 and len(c.buffer) == len(jbuf) == 24
    np.testing.assert_array_equal(c.buffer.tree.tree, jbuf.tree.tree)
    sampled, real_sample = [], c.buffer.sample
    c.buffer.sample = lambda *a, **kw: sampled.append(real_sample(*a, **kw)) or sampled[-1]

    for it in range(2):
        # --- JAX, in _run_sync's order -----------------------------------
        result = jeng.play_moves(jtc.ROLLOUT_CHUNK_MOVES)
        jbuf.add_dense(
            result.grid, result.other_features, result.policy_target, result.value_target,
            policy_weight=result.policy_weight,
        )
        jadded = result.num_experiences
        want_samples, want_results = [], []
        for _ in range(max(1, round(jadded / jtc.BATCH_SIZE))):
            s = jbuf.sample(jtc.BATCH_SIZE, current_train_step=jtrainer.global_step)
            metrics, td = jtrainer.train_step(s["batch"])
            jbuf.update_priorities(s["indices"], td)
            if jtrainer.global_step % jtc.WORKER_UPDATE_FREQ_STEPS == 0:
                jtrainer.sync_to_network()
            want_samples.append(s)
            want_results.append((metrics, td))

        # --- the port's loop: one iteration ------------------------------
        sampled.clear()
        added = loop._process_rollout()
        ran = loop._run_training_steps(max(1, round(added / jtc.BATCH_SIZE)))

        assert added == jadded > 0 and len(c.buffer) == len(jbuf)
        assert ran == len(want_results) > 0
        for name, col in jbuf._storage.items():
            got, want = c.buffer._storage[name][: len(jbuf)], col[: len(jbuf)]
            if name == "value_target":  # n-step returns: float sums in another order
                np.testing.assert_allclose(got, want, atol=1e-5)
            elif name == "other_features":
                np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
        for got, want in zip(sampled, want_samples, strict=True):
            np.testing.assert_array_equal(got["indices"], want["indices"])
            np.testing.assert_allclose(got["weights"], want["weights"], rtol=LOSS_RTOL)
        for m, (jm, _) in zip(loop.metrics[len(loop.metrics) - ran :], want_results):
            for key, ref in jm.items():
                np.testing.assert_allclose(m[key], ref, rtol=LOSS_RTOL, err_msg=key)
    assert loop.global_step == c.trainer.global_step == jtrainer.global_step
    # The cadence counts on from the resumed step: a save at step 4.
    assert c.checkpoints.valid_steps() == [2, 4]
