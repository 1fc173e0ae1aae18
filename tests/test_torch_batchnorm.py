"""`NORM_TYPE="batch"` training in the PyTorch port (`nn/model.py`
BatchNorm's train mode, `rl/trainer.py`, `stats/persistence.py`,
`nn/convert.py`, `rl/megastep.py`) against the JAX package.

Tolerances are `test_torch_learner.py`'s: losses and TD errors 1e-4
relative over K fused steps, moments 1e-4 relative, parameters 1e-3 of
the learning rate per step apart from Adam's sign flips on rounding-
sized gradients. A batch norm subtracts the batch mean, so the biases of
the convs and denses it follows, and the weights of inputs constant over
the batch, have gradients that are rounding noise
(`torch_parity.rounding_sized`): Adam moves each such entry by up to the
learning rate in either sign, the update norm differs by at most those
entries' share, and the running means, which see the biases through the
batch mean, differ by at most (1 - 0.99) times the biases' drift.
Running variances (shift-invariant) within 1e-4.

- K learner steps against the JAX trainer.
- REMAT recomputes the residual blocks in the backward pass; the running
  statistics and parameters stay bit-equal to the run without it.
- `get_state` / `set_state`, `train_state_from_flax(batch_stats=...)`
  and a checkpoint round trip carry the running statistics bit for bit;
  a group-norm checkpoint written before they were carried still loads.
- One megastep with batch norm and bf16 inference against the JAX
  megastep: the same rows, slots and losses; one cast per megastep. (A
  second megastep's rollout is not compared: its eval-mode forward
  reads the noise biases, which eval-mode batch norm does not cancel.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.rl.trainer import Trainer as JaxTrainer  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork, flax_to_torch, precision  # noqa: E402
from alphatriangle_tpu_torch.rl import Trainer  # noqa: E402
from alphatriangle_tpu_torch.stats import CheckpointManager  # noqa: E402
from alphatriangle_tpu_torch.training import setup_training_components  # noqa: E402
from test_torch_checkpoint import jax_train_state  # noqa: E402
from test_torch_learner import _assert_moments, _batch, _pair, _train_cfg  # noqa: E402
from test_torch_megastep import _jax_side, _warm_up, make_cfg  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    CPU,
    assert_params_close,
    converted_state_dict,
    inject_jax_noise,
    jax_adam_moments,
    rounding_sized,
    run_root,
    small_model_config,
    torch_cfg,
)

LOSS_RTOL = 1e-4
MOMENT_RTOL = 1e-4
LR = 1e-3
MOMENTUM_COMPLEMENT = 0.01  # 1 - flax.linen.BatchNorm's momentum


def _stats(tree) -> dict:
    """A JAX batch_stats tree under the port's buffer names."""
    return flax_to_torch({"batch_stats": jax.tree_util.tree_map(np.asarray, tree)})


def _assert_running_stats(model, jstats, noise_drift: float) -> None:
    want = _stats(jstats)
    buffers = dict(model.named_buffers())
    assert want and set(want) <= set(buffers)
    for name, ref in want.items():
        atol = 1e-6 + (MOMENTUM_COMPLEMENT * noise_drift if name.endswith("mean") else 0.0)
        np.testing.assert_allclose(
            buffers[name].numpy(), ref.numpy(), rtol=MOMENT_RTOL, atol=atol, err_msg=name
        )


def _rounding(jopt_state) -> dict:
    return rounding_sized(jax_adam_moments(jopt_state)[1])


def _update_norm_bound(rounding) -> float:
    """|update_norm^2 - JAX's| at most: each noise entry moves by <= LR."""
    return sum(int(m.sum()) for m in rounding.values()) * LR**2


class TestLearner:
    def test_k_steps_match_jax(self, tiny_env_config):
        jt, tt, model_cfg = _pair(tiny_env_config, NORM_TYPE="batch")
        k = 3
        batches = [_batch(tiny_env_config, model_cfg, 16, seed=20 + i) for i in range(k)]
        stacked = {key: np.stack([b[key] for b in batches]) for key in batches[0]}
        jstate, jmetrics, jtd = jax.jit(jt._train_steps_impl)(
            jt.state, {key: jnp.asarray(v) for key, v in stacked.items()}
        )
        metrics, td = tt._train_steps_impl({key: torch.from_numpy(v) for key, v in stacked.items()})
        rounding = _rounding(jstate.opt_state)
        for key, ref in jmetrics.items():
            if key == "update_norm":
                gap = np.abs(metrics[key].numpy() ** 2 - np.asarray(ref) ** 2)
                assert (gap <= _update_norm_bound(rounding)).all(), gap
            else:
                np.testing.assert_allclose(metrics[key].numpy(), np.asarray(ref), rtol=LOSS_RTOL, err_msg=key)
        np.testing.assert_allclose(td.numpy(), np.asarray(jtd), rtol=LOSS_RTOL, atol=1e-6)
        assert_params_close(tt.model, jstate.params, LR, k, rounding=rounding)
        _assert_moments(tt, jstate.opt_state, rounding=rounding)
        # The noise biases drift apart by up to 2 LR a step, and the
        # running means see them from the second step on.
        _assert_running_stats(tt.model, jstate.batch_stats, noise_drift=2 * LR * (k - 1))
        assert not tt.model.training

    def test_remat_changes_no_bit(self, tiny_env_config):
        model_cfg = torch_cfg(small_model_config(tiny_env_config, NORM_TYPE="batch"))
        env_cfg = torch_cfg(tiny_env_config)
        calls = {}
        trainers = {}
        for remat in (False, True):
            cfg = model_cfg.model_copy(update={"REMAT": remat})
            net = NeuralNetwork(cfg, env_cfg, seed=4, device=CPU)
            trainers[remat] = Trainer(net, torch_cfg(_train_cfg()))
            block = trainers[remat].model.ResidualBlock_0
            calls[remat] = []

            def counted(x, _forward=block.forward, _calls=calls[remat]):
                _calls.append(1)
                return _forward(x)

            block.forward = counted
        first = _batch(tiny_env_config, model_cfg, 16, seed=30)
        second = _batch(tiny_env_config, model_cfg, 16, seed=31)
        stacked = {key: np.stack([first[key], second[key]]) for key in first}
        for t in trainers.values():
            t._train_steps_impl({key: torch.from_numpy(v) for key, v in stacked.items()})
        # REMAT ran each residual block's forward again in the backward pass.
        assert (len(calls[False]), len(calls[True])) == (2, 4)
        plain, remat = trainers[False].model, trainers[True].model
        for (name, a), (_, b) in zip(plain.state_dict().items(), remat.state_dict().items()):
            assert torch.equal(a, b), name
        # The statistics moved once a step: the two-step update from init.
        assert not torch.equal(plain.ResidualBlock_0._Norm_0.BatchNorm_0.running_var, torch.ones(16))


class TestState:
    def test_state_round_trip_and_jax_batch_stats(self, tmp_path, tiny_env_config):
        jt, tt, model_cfg = _pair(tiny_env_config, NORM_TYPE="batch")
        batch = _batch(tiny_env_config, model_cfg, 16, seed=3)
        jt.train_step(batch)
        tt.train_step(batch)
        state = tt.get_state()
        names = {n for n, _ in tt.model.named_buffers() if "running" in n}
        assert set(state["batch_stats"]) == names and len(names) == 14
        # get_state / set_state and a checkpoint, bit for bit.
        mgr = CheckpointManager(run_root(tmp_path, "bn"))
        mgr.save(1, state)
        fresh = _pair(tiny_env_config, NORM_TYPE="batch")[1]
        fresh.set_state(mgr.restore().train_state)
        for name in names:
            assert torch.equal(dict(fresh.model.named_buffers())[name], state["batch_stats"][name])
        fresh.sync_to_network()
        assert all(
            torch.equal(dict(fresh.nn.model.named_buffers())[n], state["batch_stats"][n]) for n in names
        )
        # A JAX learner's running statistics through train_state_from_flax.
        carried = jax_train_state(jt.state)
        assert set(carried["batch_stats"]) == names
        fresh.set_state(carried)
        want = _stats(jt.state.batch_stats)
        for name in names:
            assert torch.equal(dict(fresh.model.named_buffers())[name], want[name]), name

    def test_checkpoint_without_batch_stats(self, tmp_path, tiny_env_config, tiny_model_config):
        """A group-norm snapshot as written before `batch_stats` was carried
        still restores; a batch-norm learner refuses one that lacks them."""
        trainer = Trainer(
            NeuralNetwork(torch_cfg(tiny_model_config), torch_cfg(tiny_env_config), device=CPU),
            torch_cfg(_train_cfg()),
        )
        old = trainer.get_state()
        assert old.pop("batch_stats") == {}
        mgr = CheckpointManager(run_root(tmp_path, "old"))
        mgr.save(3, old)
        fresh = Trainer(
            NeuralNetwork(torch_cfg(tiny_model_config), torch_cfg(tiny_env_config), seed=5, device=CPU),
            torch_cfg(_train_cfg()),
        )
        fresh.set_state(mgr.restore().train_state)
        assert fresh.global_step == old["step"]
        for name, p in fresh.model.named_parameters():
            assert torch.equal(p.detach(), old["params"][name]), name
        bn = _pair(tiny_env_config, NORM_TYPE="batch")[1]
        bn_state = bn.get_state()
        bn_state.pop("batch_stats")
        with pytest.raises(ValueError, match="batch_stats names differ"):
            bn.set_state(bn_state)


class TestMegastep:
    def test_batch_norm_bf16_megastep_matches_jax(
        self, monkeypatch, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
    ):
        inject_jax_noise(monkeypatch)
        model_cfg = tiny_model_config.model_copy(
            update={"NORM_TYPE": "batch", "INFERENCE_PRECISION": "bfloat16"}
        )
        jtc = make_cfg(RUN_NAME="bn_mega")
        jeng, jtrainer, jring, jrunner, jnet, jouts = _jax_side(
            tiny_env_config, model_cfg, tiny_mcts_config, jtc
        )
        c = setup_training_components(
            torch_cfg(jtc), torch_cfg(tiny_env_config), torch_cfg(model_cfg),
            torch_cfg(tiny_mcts_config), persistence_config=run_root(tmp_path), device=CPU,
        )
        c.net.model.load_state_dict(converted_state_dict(jnet))
        assert _warm_up(c.self_play, c.buffer, jtc) == _warm_up(jeng, jring, jtc)
        jrunner.sync_priorities_from_host()
        c.megastep.sync_priorities_from_host()
        k = jtc.FUSED_LEARNER_STEPS
        casts = precision.InferenceNet.casts
        jres, jcount = jrunner.run_megastep(jtc.ROLLOUT_CHUNK_MOVES, k)
        res, count = c.megastep.run_megastep(jtc.ROLLOUT_CHUNK_MOVES, k)
        assert precision.InferenceNet.casts == casts + 1  # one cast a megastep
        assert count == jcount > 0
        assert (c.buffer._pos, len(c.buffer)) == (jring._pos, len(jring))
        np.testing.assert_array_equal(c.megastep.last_idx, np.asarray(jouts[0]["idx"]))
        for name, col in jring.storage.items():
            got, want = c.buffer.storage[name][: len(jring)].numpy(), np.asarray(col)[: len(jring)]
            if name == "value_target":
                np.testing.assert_allclose(got, want, atol=1e-5)
            elif name == "other_features":
                np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
        for (m, td), (jm, jtd) in zip(res, jres):
            for key in ("total_loss", "policy_loss", "value_loss", "entropy", "grad_norm"):
                np.testing.assert_allclose(m[key], jm[key], rtol=LOSS_RTOL, err_msg=key)
            np.testing.assert_allclose(td, jtd, rtol=LOSS_RTOL, atol=1e-6)
        rounding = _rounding(jtrainer.state.opt_state)
        assert_params_close(c.net.model, jtrainer.state.params, LR, k, rounding=rounding)
        _assert_running_stats(c.net.model, jtrainer.state.batch_stats, noise_drift=2 * LR * (k - 1))
        # The next megastep casts the trained module afresh (its eval-mode
        # forward reads the moved running statistics), once.
        stats = {n: b.clone() for n, b in c.net.model.named_buffers() if "running" in n}
        c.megastep.run_megastep(jtc.ROLLOUT_CHUNK_MOVES, k)
        assert precision.InferenceNet.casts == casts + 2
        assert all(not torch.equal(b, stats[n]) for n, b in c.net.model.named_buffers() if n in stats)
        assert all(torch.isfinite(b).all() for b in c.net.model.buffers())
