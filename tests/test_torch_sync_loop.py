"""Parity of the PyTorch port's synchronous training loop and its pieces
with the JAX package: the SumTree's insert and sampling half, the host
ring, the device ring's host adds and draws, the learner's host API,
the weight sync, and one whole synchronous iteration.

Exact: the SumTree, the host ring and the device ring (NumPy on both
sides, the same `np.random.Generator` draws), and in the loop the rows
each chunk ingests, the sampled slots, the step count and the importance
weights drawn from priorities both sides hold exactly (the watermark of
fresh rows). Within tolerance: losses and TD errors 1e-4 relative
(gradients summed in another order), the SumTree priorities after TD
updates and the importance weights drawn from them 1e-4 relative
(`(|td| + eps)^alpha` of those TD errors), parameters 1e-3 of the
learning rate per step apart from Adam's sign flips on rounding-sized
gradients (as in `test_torch_learner.py`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.rl.buffer import ExperienceBuffer as JaxBuffer  # noqa: E402
from alphatriangle_tpu.rl.device_buffer import DeviceReplayBuffer as JaxRing  # noqa: E402
from alphatriangle_tpu.rl.self_play import SelfPlayEngine as JaxEngine  # noqa: E402
from alphatriangle_tpu.rl.trainer import Trainer as JaxTrainer  # noqa: E402
from alphatriangle_tpu.utils.sumtree import SumTree as JaxSumTree  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork  # noqa: E402
from alphatriangle_tpu_torch.ops import KERNELS  # noqa: E402
from alphatriangle_tpu_torch.rl import DeviceReplayBuffer, Trainer  # noqa: E402
from alphatriangle_tpu_torch.rl.buffer import ExperienceBuffer  # noqa: E402
from alphatriangle_tpu_torch.training import (  # noqa: E402
    TrainingLoop,
    setup_training_components,
)
from alphatriangle_tpu_torch.utils.sumtree import SumTree  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    CPU,
    assert_params_close,
    converted_state_dict,
    dense_rows,
    inject_jax_noise,
    run_root,
    small_model_config,
    torch_cfg,
)

GRID, OTHER, ACTIONS = (1, 3, 4), 5, 12
LOSS_RTOL = 1e-4


def _ring_cfg(**kw) -> JaxTrainConfig:
    base = dict(
        BATCH_SIZE=6, BUFFER_CAPACITY=40, MIN_BUFFER_SIZE_TO_TRAIN=10, USE_PER=True,
        PER_BETA_ANNEAL_STEPS=10, AUTO_RESUME_LATEST=False, RUN_NAME="sync", RANDOM_SEED=3,
    )
    base.update(kw)
    return JaxTrainConfig(**base)


class TestSumTree:
    def test_insert_and_sampling_match_jax_exactly(self):
        ours, ref = SumTree(37), JaxSumTree(37)
        pick = np.random.default_rng(0)
        gen_ours, gen_ref = np.random.default_rng(9), np.random.default_rng(9)
        assert ours.add(2.5, "a") == ref.add(2.5, "a") == 0
        for step in range(5):
            prios = pick.random(11) * (step + 1)
            items = [f"x{step}.{i}" for i in range(11)]  # wraps the ring past 37
            np.testing.assert_array_equal(ours.add_batch(prios, items), ref.add_batch(prios, items))
            assert (ours.data_pointer, ours.n_entries) == (ref.data_pointer, ref.n_entries)
            assert ours.data == ref.data
            np.testing.assert_array_equal(ours.tree, ref.tree)
            values = pick.random(9) * ours.total_priority
            for got, want in zip(ours.get_leaves(values), ref.get_leaves(values)):
                np.testing.assert_array_equal(got, want)
            for got, want in zip(ours.sample_batch(7, gen_ours), ref.sample_batch(7, gen_ref)):
                np.testing.assert_array_equal(got, want)
            v = float(values[0])
            assert ours.get_leaf(v) == ref.get_leaf(v)
        ours.update(3, 0.0)
        ref.update(3, 0.0)
        np.testing.assert_array_equal(ours.tree, ref.tree)
        assert (ours.max_priority, len(ours)) == (ref.max_priority, len(ref))

    def test_empty_tree_refuses_to_sample(self):
        with pytest.raises(ValueError, match="empty"):
            SumTree(4).sample_batch(2, np.random.default_rng(0))
        slots, prios = SumTree(4).get_leaves(np.zeros(0))
        assert slots.shape == prios.shape == (0,)


def _assert_sample(got, want):
    assert set(got) == set(want)
    for key in ("indices", "weights"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key].dtype == want[key].dtype, key
    if "batch" in want:
        assert set(got["batch"]) == set(want["batch"])
        for key, v in want["batch"].items():
            np.testing.assert_array_equal(got["batch"][key], v, err_msg=key)
            assert got["batch"][key].dtype == v.dtype, key


class TestHostRing:
    @pytest.mark.parametrize("use_per", [True, False])
    def test_add_dense_and_sample_match_jax_exactly(self, use_per):
        jcfg = _ring_cfg(USE_PER=use_per)
        ours, ref = ExperienceBuffer(torch_cfg(jcfg)), JaxBuffer(jcfg)
        assert ours.sample(6, 0) is ref.sample(6, 0) is None  # not ready
        for seed in range(5):
            rows = dense_rows(seed, 13, GRID, OTHER, ACTIONS, nonfinite=seed % 2 == 0)
            np.testing.assert_array_equal(ours.add_dense(**rows), ref.add_dense(**rows))
            assert (ours._pos, len(ours), ours.is_ready()) == (ref._pos, len(ref), ref.is_ready())
            for name, col in ref._storage.items():
                np.testing.assert_array_equal(ours._storage[name], col, err_msg=name)
                assert ours._storage[name].dtype == col.dtype, name
            if use_per:
                np.testing.assert_array_equal(ours.tree.tree, ref.tree.tree)
            got, want = ours.sample(6, current_train_step=seed), ref.sample(6, current_train_step=seed)
            _assert_sample(got, want)
            td = np.random.default_rng(seed).normal(size=6)
            ours.update_priorities(got["indices"], td)
            ref.update_priorities(want["indices"], td)
        assert len(ours) == len(ref) == 40  # wrapped

    def test_non_finite_rows_are_dropped_as_jax_drops_them(self):
        jcfg = _ring_cfg()
        ours, ref = ExperienceBuffer(torch_cfg(jcfg)), JaxBuffer(jcfg)
        rows = dense_rows(4, 8, GRID, OTHER, ACTIONS, nonfinite=True)
        kept = ours.add_dense(**rows)
        np.testing.assert_array_equal(kept, ref.add_dense(**rows))
        assert len(kept) < 8
        bad = {k: v[:1].copy() for k, v in rows.items()}
        bad["value_target"][:] = np.inf
        assert ours.add_dense(**bad).shape == ref.add_dense(**bad).shape == (0,)
        ours.add_dense(**dense_rows(0, 12, GRID, OTHER, ACTIONS))
        with pytest.raises(ValueError, match="current_train_step"):
            ours.sample(4)

    def test_tuple_adds_match_jax(self):
        jcfg = _ring_cfg(USE_PER=False)
        ours = ExperienceBuffer(torch_cfg(jcfg), action_dim=ACTIONS)
        ref = JaxBuffer(jcfg, action_dim=ACTIONS)
        rows = dense_rows(1, 5, GRID, OTHER, ACTIONS)
        tuples = [
            (
                {"grid": rows["grid"][i], "other_features": rows["other_features"][i]},
                {a: float(p) for a, p in enumerate(rows["policy_target"][i]) if p > 0.1},
                float(rows["value_target"][i]),
            )
            for i in range(5)
        ]
        ours.add(tuples[0])
        ref.add(tuples[0])
        ours.add_batch(tuples[1:])
        ref.add_batch(tuples[1:])
        for name, col in ref._storage.items():
            np.testing.assert_array_equal(ours._storage[name], col, err_msg=name)
        with pytest.raises(ValueError, match="action_dim"):
            ExperienceBuffer(torch_cfg(jcfg)).add(tuples[0])


class TestDeviceRing:
    def test_add_dense_and_sample_match_jax_exactly(self):
        jcfg = _ring_cfg()
        ref = JaxRing(jcfg, grid_shape=GRID, other_dim=OTHER, action_dim=ACTIONS)
        ours = DeviceReplayBuffer(
            torch_cfg(jcfg), grid_shape=GRID, other_dim=OTHER, action_dim=ACTIONS, device=CPU
        )
        for seed in range(4):
            rows = dense_rows(seed, 13, GRID, OTHER, ACTIONS, nonfinite=True, not_a_policy=True)
            np.testing.assert_array_equal(ours.add_dense(**rows), ref.add_dense(**rows))
            assert (ours._pos, len(ours)) == (ref._pos, len(ref))
            np.testing.assert_array_equal(ours.tree.tree, ref.tree.tree)
            _assert_sample(ours.sample(6, current_train_step=seed), ref.sample(6, current_train_step=seed))
        for name, col in ref.storage.items():
            np.testing.assert_array_equal(ours.storage[name][:-1].numpy(), np.asarray(col)[:-1])
        assert ours.dispatch_count == ref.dispatch_count == 4


def _learner_pair(env_cfg, **train_kw):
    model_cfg = small_model_config(env_cfg, USE_TRANSFORMER=False, TRANSFORMER_LAYERS=0)
    jcfg = JaxTrainConfig(
        AUTO_RESUME_LATEST=False, RUN_NAME="sync_learner", BATCH_SIZE=16, BUFFER_CAPACITY=64,
        MIN_BUFFER_SIZE_TO_TRAIN=16, MAX_TRAINING_STEPS=50, RANDOM_SEED=7, LEARNING_RATE=1e-3,
        **train_kw,
    )
    jnet = JaxNetwork(model_cfg, env_cfg, seed=3)
    tnet = NeuralNetwork(
        torch_cfg(model_cfg), torch_cfg(env_cfg), state_dict=converted_state_dict(jnet), device=CPU
    )
    return JaxTrainer(jnet, jcfg), Trainer(tnet, torch_cfg(jcfg)), model_cfg


def _host_batch(env_cfg, model_cfg, seed: int) -> dict:
    rows = dense_rows(
        seed, 16, (1, env_cfg.ROWS, env_cfg.COLS), model_cfg.OTHER_NN_INPUT_FEATURES_DIM,
        env_cfg.action_dim,
    )
    pick = np.random.default_rng(seed + 100)
    return {
        **rows,
        "weights": pick.uniform(0.2, 1.0, 16).astype(np.float32),
        "policy_weight": (pick.random(16) < 0.8).astype(np.float32),
    }


def _assert_results(got, want):
    assert len(got) == len(want)
    for (m, td), (jm, jtd) in zip(got, want):
        assert set(m) == set(jm)
        for key, ref in jm.items():
            np.testing.assert_allclose(m[key], ref, rtol=LOSS_RTOL, err_msg=key)
        np.testing.assert_allclose(td, np.asarray(jtd), rtol=LOSS_RTOL, atol=1e-6)


class TestLearnerHostApi:
    def test_train_step_from_a_host_batch_matches_jax(self, tiny_env_config):
        jt, tt, model_cfg = _learner_pair(tiny_env_config)
        for seed in (1, 2):
            batch = _host_batch(tiny_env_config, model_cfg, seed)
            _assert_results([tt.train_step(batch)], [jt.train_step(batch)])
        assert tt.global_step == jt.global_step == 2
        assert tt.get_current_lr() == pytest.approx(jt.get_current_lr(), rel=1e-6)
        assert tt.dispatch_count == 2 and tt.transfer_h2d_seconds > 0
        empty = {k: v[:0] for k, v in _host_batch(tiny_env_config, model_cfg, 3).items()}
        assert tt.train_step(empty) is None

    def test_begin_finish_pipeline_matches_jax(self, tiny_env_config):
        jt, tt, model_cfg = _learner_pair(tiny_env_config)
        groups = [[_host_batch(tiny_env_config, model_cfg, 10 * g + i) for i in range(2)] for g in range(2)]
        # Two groups in flight at once, finished oldest first.
        handles = [tt.train_steps_begin(g) for g in groups]
        jhandles = [jt.train_steps_begin(g) for g in groups]
        assert tt.global_step == jt.global_step == 4  # the counter moves at begin
        for h, jh in zip(handles, jhandles):
            _assert_results(tt.train_steps_finish(h), jt.train_steps_finish(jh))
        assert tt.train_steps([]) == [] and tt.train_steps_begin([]) is None
        assert_params_close(tt.model, jt.state.params, lr=1e-3, steps=4)


def _components(root, env_cfg, model_cfg, mcts_cfg, **train_kw):
    tc = torch_cfg(_ring_cfg(**train_kw))
    return setup_training_components(
        tc, torch_cfg(env_cfg), torch_cfg(model_cfg), torch_cfg(mcts_cfg),
        persistence_config=run_root(root), device=CPU,
    )


class TestWeightSync:
    def test_sync_installs_a_copy_and_chunks_keep_theirs(
        self, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
    ):
        c = _components(tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config, BATCH_SIZE=4)
        net, trainer = c.net, c.trainer
        assert trainer.model is not net.model  # the learner owns a copy
        assert not any(
            p.data_ptr() == q.data_ptr() for p, q in zip(trainer.model.parameters(), net.model.parameters())
        )
        before = net.live
        grid = (1, tiny_env_config.ROWS, tiny_env_config.COLS)
        c.buffer.add_dense(
            **dense_rows(0, 12, grid, c.extractor.other_dim, tiny_env_config.action_dim)
        )
        trainer.train_step(c.buffer.sample(4, current_train_step=0)["batch"])
        assert all(torch.equal(a, b) for a, b in zip(before.model.parameters(), net.model.parameters()))
        assert not all(
            torch.equal(a, b) for a, b in zip(trainer.model.parameters(), net.model.parameters())
        )
        assert trainer.sync_to_network() == net.weights_version == 1
        assert net.model is not before.model and net.model is not trainer.model
        for (name, a), b in zip(trainer.model.state_dict().items(), net.model.state_dict().values()):
            assert torch.equal(a, b), name
        assert not net.model.training and not any(p.requires_grad for p in net.model.parameters())
        # What a chunk captured before the sync is untouched by it.
        assert before.version == 0 and not all(
            torch.equal(a, b) for a, b in zip(before.model.parameters(), net.model.parameters())
        )

    def test_a_running_chunk_reads_one_set_of_weights(
        self, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
    ):
        """A sync lands between two moves of a chunk: the chunk goes on
        searching with the module it captured, and its episodes are
        tagged with the version they started under."""
        c = _components(
            tmp_path,
            tiny_env_config, tiny_model_config, tiny_mcts_config,
            SELF_PLAY_BATCH_SIZE=3, MAX_EPISODE_MOVES=2,
        )
        engine = c.self_play
        seen, real_body = [], engine._move_body

        def body(carry, version):
            seen.append((engine.mcts.model, version))
            if len(seen) == 2 and c.net.weights_version == 0:
                c.trainer.sync_to_network()  # as a learner thread would, mid-chunk
            return real_body(carry, version)

        engine._move_body = body
        result = engine.play_moves(4)
        assert c.net.weights_version == 1
        assert [v for _, v in seen] == [0] * 4 and len({id(m) for m, _ in seen}) == 1
        assert result.num_episodes > 0 and set(result.episode_start_versions) == {0}
        assert result.trainer_step_at_episode_start == 0
        seen.clear()
        result = engine.play_moves(4)
        assert [v for _, v in seen] == [1] * 4 and seen[0][0] is c.net.model
        assert set(result.episode_start_versions) == {0, 1}

    def test_megastep_shares_the_module_and_has_nothing_to_sync(
        self, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
    ):
        c = _components(
            tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config, FUSED_MEGASTEP=True
        )
        assert c.trainer.model is c.net.model
        with pytest.raises(RuntimeError, match="nothing to sync"):
            c.trainer.sync_to_network()


def _loop_cfg() -> JaxTrainConfig:
    """The JAX loop tests' tiny run (tests/test_training_loop.py)."""
    return JaxTrainConfig(
        RUN_NAME="sync_parity", AUTO_RESUME_LATEST=False, MAX_TRAINING_STEPS=8,
        SELF_PLAY_BATCH_SIZE=4, ROLLOUT_CHUNK_MOVES=4, BATCH_SIZE=8, BUFFER_CAPACITY=2000,
        MIN_BUFFER_SIZE_TO_TRAIN=16, USE_PER=True, PER_BETA_ANNEAL_STEPS=8, N_STEP_RETURNS=2,
        WORKER_UPDATE_FREQ_STEPS=2, CHECKPOINT_SAVE_FREQ_STEPS=4, MAX_EPISODE_MOVES=30,
        RANDOM_SEED=5,
    )


class TestSyncIteration:
    def test_iterations_match_jax(
        self, monkeypatch, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
    ):
        """Two synchronous iterations (the first leaves the ring short of
        MIN_BUFFER_SIZE_TO_TRAIN; the second trains two single steps and
        syncs at step 2): the JAX components driven in `_run_sync`'s
        order against the port's loop."""
        inject_jax_noise(monkeypatch)
        jtc = _loop_cfg()
        env = JaxEnv(tiny_env_config)
        jnet = JaxNetwork(tiny_model_config, tiny_env_config, seed=jtc.RANDOM_SEED)
        jtrainer = JaxTrainer(jnet, jtc)
        jbuf = JaxBuffer(jtc, action_dim=tiny_env_config.action_dim)
        jeng = JaxEngine(
            env, get_feature_extractor(env, tiny_model_config), jnet, tiny_mcts_config, jtc,
            seed=jtc.RANDOM_SEED + 1,
        )
        c = setup_training_components(
            torch_cfg(jtc), torch_cfg(tiny_env_config), torch_cfg(tiny_model_config),
            torch_cfg(tiny_mcts_config), persistence_config=run_root(tmp_path), device=CPU,
        )
        assert not c.buffer.is_device  # "auto" on the CPU: the host ring
        state = converted_state_dict(jnet)
        c.net.model.load_state_dict(state)  # before any chunk: version 0 on both sides
        c.trainer.model.load_state_dict(state)
        loop = TrainingLoop(c)
        sampled, real_sample = [], c.buffer.sample
        c.buffer.sample = lambda *a, **kw: sampled.append(real_sample(*a, **kw)) or sampled[-1]
        before = {name: kern.launches for name, kern in KERNELS.items()}

        jsteps = jsyncs = 0
        for it in range(2):
            # --- JAX, in _run_sync's order -----------------------------
            result = jeng.play_moves(jtc.ROLLOUT_CHUNK_MOVES)
            jbuf.add_dense(
                result.grid, result.other_features, result.policy_target, result.value_target,
                policy_weight=result.policy_weight,
            )
            jadded = result.num_experiences
            want_samples, want_results = [], []
            for _ in range(max(1, round(jadded / jtc.BATCH_SIZE))):
                s = jbuf.sample(jtc.BATCH_SIZE, current_train_step=jtrainer.global_step)
                if s is None:
                    break
                metrics, td = jtrainer.train_step(s["batch"])
                jbuf.update_priorities(s["indices"], td)
                jsteps += 1
                if jsteps % jtc.WORKER_UPDATE_FREQ_STEPS == 0:
                    jtrainer.sync_to_network()
                    jsyncs += 1
                want_samples.append(s)
                want_results.append((metrics, td))

            # --- the port's loop: one iteration ----------------------------
            sampled.clear()
            added = loop._process_rollout()
            ran = loop._run_training_steps(max(1, round(added / jtc.BATCH_SIZE)))
            got_samples = [s for s in sampled if s is not None]

            assert added == jadded > 0 and len(c.buffer) == len(jbuf)
            assert ran == len(want_results) == (0 if it == 0 else 2)
            for name, col in jbuf._storage.items():
                got = c.buffer._storage[name][: len(jbuf)]
                want = col[: len(jbuf)]
                if name == "value_target":  # n-step returns: float sums in another order
                    np.testing.assert_allclose(got, want, atol=1e-5)
                elif name == "other_features":
                    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
                else:
                    np.testing.assert_array_equal(got, want, err_msg=name)
            for j, (got, want) in enumerate(zip(got_samples, want_samples)):
                np.testing.assert_array_equal(got["indices"], want["indices"])
                if j == 0:  # drawn from watermark priorities: exact
                    np.testing.assert_array_equal(got["weights"], want["weights"])
                else:  # drawn from priorities of TD errors
                    np.testing.assert_allclose(got["weights"], want["weights"], rtol=LOSS_RTOL)
            for m, (jm, _) in zip(loop.metrics[len(loop.metrics) - ran:], want_results):
                for key, ref in jm.items():
                    np.testing.assert_allclose(m[key], ref, rtol=LOSS_RTOL, err_msg=key)
            tree = c.buffer.tree
            np.testing.assert_allclose(tree.tree, jbuf.tree.tree, rtol=LOSS_RTOL, atol=1e-12)
            assert tree.max_priority == pytest.approx(jbuf.tree.max_priority, rel=LOSS_RTOL)

        assert {name: kern.launches for name, kern in KERNELS.items()} == before  # CPU
        assert loop.global_step == c.trainer.global_step == jtrainer.global_step == jsteps == 2
        assert loop.weight_updates == jsyncs == 1 == c.net.weights_version == jnet.weights_version
        for a, b in zip(c.trainer.model.parameters(), c.net.model.parameters()):
            assert torch.equal(a, b)
        assert_params_close(c.net.model, jax.device_get(jnet.variables["params"]), jtc.LEARNING_RATE, 2)
        assert loop.episodes_played == 0 or loop.staleness
