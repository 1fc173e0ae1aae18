"""Parity of the PyTorch port's learner (`rl/trainer.py`) and the
transformer's train mode (`nn/model.py`) with the JAX package.

From the same parameters (`flax_to_torch`) and the same batch (made
with NumPy), one step and K fused steps must give the JAX learner's
metrics, TD errors, parameters and optimizer moments. The two frameworks
sum gradients and norms in other orders, so the comparisons carry
tolerances: losses and TD errors 1e-5 relative; moments 1e-4 relative
with an absolute floor at 1e-5 of each tensor's largest entry; and
parameters 1e-3 of the learning rate per step, except where a gradient
is so close to zero that its sign is rounding (Adam's first step moves
each parameter by about the learning rate in the gradient's sign). The
whole-step parity runs without the transformer: Flax draws dropout keys
from module paths, which the port does not reproduce. The transformer's
train mode is held layer by layer against the Flax layer with dropout
0, and the port's dropout by its keep rate and scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.nn.model import TransformerEncoderLayer as JaxLayer  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.rl.trainer import Trainer as JaxTrainer  # noqa: E402
from alphatriangle_tpu.rl.trainer import make_lr_schedule as jax_schedule  # noqa: E402
from alphatriangle_tpu.rl.trainer import project_to_support as jax_project  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork, flax_to_torch  # noqa: E402
from alphatriangle_tpu_torch.nn.model import TransformerEncoderLayer, dropout  # noqa: E402
from alphatriangle_tpu_torch.rl import Trainer, make_lr_schedule, project_to_support  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    CPU,
    ROUNDING_RMS,
    assert_params_close,
    converted_state_dict,
    jax_adam_moments,
    rounding_sized,
    small_model_config,
    torch_cfg,
)

LOSS_RTOL = 1e-5
MOMENT_RTOL = 1e-4


def _train_cfg(**kw) -> JaxTrainConfig:
    base = dict(
        AUTO_RESUME_LATEST=False, RUN_NAME="learner", BATCH_SIZE=16, BUFFER_CAPACITY=64,
        MIN_BUFFER_SIZE_TO_TRAIN=16, MAX_TRAINING_STEPS=50, RANDOM_SEED=7,
        LEARNING_RATE=1e-3, ENTROPY_BONUS_WEIGHT=0.01,
    )
    base.update(kw)
    return JaxTrainConfig(**base)


def _batch(env_cfg, model_cfg, n: int, seed: int) -> dict:
    pick = np.random.default_rng(seed)
    policy = pick.random((n, env_cfg.action_dim)).astype(np.float32) ** 3
    policy /= policy.sum(-1, keepdims=True)
    return {
        "grid": pick.integers(-1, 2, (n, 1, env_cfg.ROWS, env_cfg.COLS)).astype(np.float32),
        "other_features": pick.random((n, model_cfg.OTHER_NN_INPUT_FEATURES_DIM)).astype(np.float32),
        "policy_target": policy,
        "value_target": (pick.normal(size=n) * 6).astype(np.float32),  # some clip at +-10
        "weights": pick.uniform(0.2, 1.0, n).astype(np.float32),
        "policy_weight": (pick.random(n) < 0.8).astype(np.float32),
    }


def _pair(env_cfg, train_kw=None, **model_kw):
    model_cfg = small_model_config(
        env_cfg, USE_TRANSFORMER=False, TRANSFORMER_LAYERS=0, **model_kw
    )
    jcfg = _train_cfg(**(train_kw or {}))
    jnet = JaxNetwork(model_cfg, env_cfg, seed=3)
    tnet = NeuralNetwork(
        torch_cfg(model_cfg), torch_cfg(env_cfg), state_dict=converted_state_dict(jnet), device=CPU
    )
    return JaxTrainer(jnet, jcfg), Trainer(tnet, torch_cfg(jcfg)), model_cfg


def _named(tree) -> dict:
    """A Flax params-shaped tree as the port's state-dict names."""
    return flax_to_torch({"params": jax.tree_util.tree_map(np.asarray, tree)})


def _assert_params(trainer: Trainer, jparams, lr: float, steps: int):
    want = _named(jparams)
    for name, p in trainer.model.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        diff = np.abs(got - ref)
        # Adam moves a parameter by ~lr in its gradient's sign: where the
        # gradient is rounding-sized the two frameworks may take either sign.
        assert (diff > 1e-3 * lr * steps).mean() <= 0.01, (name, diff.max())
        assert diff.max() <= 2 * lr * steps, (name, diff.max())


def _assert_moments(trainer: Trainer, jopt_state, rounding=None):
    """The Adam moments within MOMENT_RTOL; at the entries `rounding`
    marks (`torch_parity.rounding_sized`), rounding-sized on both sides."""
    mu, nu, count = jax_adam_moments(jopt_state)
    names = [n for n, _ in trainer.model.named_parameters()]
    for which, ours, ref in (
        ("mu", trainer.state.opt_state.mu, mu), ("nu", trainer.state.opt_state.nu, nu)
    ):
        size = np.abs if which == "mu" else np.sqrt  # in gradient units
        top = max(float(size(v.numpy()).max()) for v in ref.values())
        for name, got in zip(names, ours):
            g, r = got.numpy(), ref[name].numpy()
            if rounding is not None:
                noise = rounding[name]
                assert (size(g[noise]) <= 2 * ROUNDING_RMS * top).all(), (which, name)
                g, r = g[~noise], r[~noise]
                if not r.size:
                    continue
            np.testing.assert_allclose(
                g, r, rtol=MOMENT_RTOL, atol=1e-5 * np.abs(r).max() + 1e-30,
                err_msg=f"{which} {name}",
            )
    assert trainer.state.opt_state.count == count


class TestPieces:
    def test_project_to_support_exact(self):
        returns = np.array([-12.0, -10.0, -3.3, 0.0, 0.25, 4.0, 9.99, 10.0, 55.0], np.float32)
        got = project_to_support(torch.from_numpy(returns), 11, -10.0, 10.0)
        want = jax_project(jnp.asarray(returns), 11, -10.0, 10.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize(
        "kw",
        [
            {},
            {"LR_SCHEDULER_TYPE": "StepLR", "LR_SCHEDULER_STEP_SIZE": 7, "LR_SCHEDULER_GAMMA": 0.3},
            {"LR_SCHEDULER_TYPE": None},
            {"LR_SCHEDULER_T_MAX": 13, "LR_SCHEDULER_ETA_MIN": 1e-4},
        ],
    )
    def test_lr_schedule_matches_optax(self, kw):
        jcfg = _train_cfg(**kw)
        ours, ref = make_lr_schedule(torch_cfg(jcfg)), jax_schedule(jcfg)
        for count in (0, 1, 5, 7, 13, 14, 49, 50, 80):
            np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6)

    def test_batch_norm_step_matches_jax(self, tiny_env_config):
        """One learner step of a batch-norm net: the JAX step's metrics,
        TD errors, parameters and moments, and its running statistics
        (moved once, by the batch's mean and biased variance) within the
        moments' tolerance. The biases a batch norm follows have
        rounding-sized gradients (`torch_parity.rounding_sized`): Adam
        moves each of their entries by up to lr in either sign, so those
        entries and their share of the update norm are held to that
        bound only."""
        jt, tt, model_cfg = _pair(tiny_env_config, NORM_TYPE="batch")
        batch = _batch(tiny_env_config, model_cfg, 16, seed=2)
        jstate, jmetrics, jtd = jax.jit(jt._train_step_impl)(
            jt.state, {k: jnp.asarray(v) for k, v in batch.items()}
        )
        metrics, td = tt._train_step_impl({k: torch.from_numpy(v) for k, v in batch.items()})
        rounding = rounding_sized(jax_adam_moments(jstate.opt_state)[1])
        # Every conv and dense bias a batch norm follows, whole.
        assert {n for n, m in rounding.items() if m.all()} == {
            n for n, _ in tt.model.named_parameters()
            if n.endswith(".bias") and "Conv_" in n or n.endswith("Dense_0.bias")
        }
        for key, ref in jmetrics.items():
            if key != "update_norm":
                np.testing.assert_allclose(float(metrics[key]), float(ref), rtol=LOSS_RTOL, err_msg=key)
        lr = 1e-3
        entries = sum(int(m.sum()) for m in rounding.values())
        assert abs(float(metrics["update_norm"]) ** 2 - float(jmetrics["update_norm"]) ** 2) <= (
            entries * lr**2
        )
        np.testing.assert_allclose(td.numpy(), np.asarray(jtd), rtol=LOSS_RTOL)
        assert_params_close(tt.model, jstate.params, lr, 1, rounding=rounding)
        _assert_moments(tt, jstate.opt_state, rounding=rounding)
        want = flax_to_torch({"batch_stats": jax.tree_util.tree_map(np.asarray, jstate.batch_stats)})
        buffers = dict(tt.model.named_buffers())
        assert len(want) == 2 * 7 and set(want) <= set(buffers)
        for name, ref in want.items():
            start = torch.zeros_like(ref) if name.endswith("mean") else torch.ones_like(ref)
            assert not torch.equal(buffers[name], start), name
            np.testing.assert_allclose(
                buffers[name].numpy(), ref.numpy(), rtol=MOMENT_RTOL, atol=1e-6, err_msg=name
            )


class TestSteps:
    @pytest.mark.parametrize(
        "optimizer,clip", [("AdamW", 1.0), ("AdamW", None), ("Adam", 0.05), ("SGD", 1.0)]
    )
    def test_one_step_matches_jax(self, tiny_env_config, optimizer, clip):
        jt, tt, model_cfg = _pair(
            tiny_env_config,
            dict(OPTIMIZER_TYPE=optimizer, GRADIENT_CLIP_VALUE=clip, WEIGHT_DECAY=0.05),
        )
        batch = _batch(tiny_env_config, model_cfg, 16, seed=1)
        jstate, jmetrics, jtd = jax.jit(jt._train_step_impl)(
            jt.state, {k: jnp.asarray(v) for k, v in batch.items()}
        )
        metrics, td = tt._train_step_impl({k: torch.from_numpy(v) for k, v in batch.items()})
        for key, ref in jmetrics.items():
            np.testing.assert_allclose(float(metrics[key]), float(ref), rtol=LOSS_RTOL, err_msg=key)
        np.testing.assert_allclose(td.numpy(), np.asarray(jtd), rtol=LOSS_RTOL)
        if optimizer == "SGD":  # no moments: parameters follow the gradient closely
            want = _named(jstate.params)
            for name, p in tt.model.named_parameters():
                np.testing.assert_allclose(
                    p.detach().numpy(), want[name].numpy(), rtol=1e-5, atol=1e-7, err_msg=name
                )
        else:
            _assert_params(tt, jstate.params, 1e-3, 1)
            _assert_moments(tt, jstate.opt_state)
        assert tt.state.step == int(jstate.step) == 1
        np.testing.assert_array_equal(tt.state.rng.numpy(), np.asarray(jstate.rng).astype(np.int64))

    def test_fused_steps_match_jax(self, tiny_env_config):
        jt, tt, model_cfg = _pair(tiny_env_config)
        k = 3
        batches = [_batch(tiny_env_config, model_cfg, 16, seed=10 + i) for i in range(k)]
        stacked = {key: np.stack([b[key] for b in batches]) for key in batches[0]}
        jstate, jmetrics, jtd = jax.jit(jt._train_steps_impl)(
            jt.state, {key: jnp.asarray(v) for key, v in stacked.items()}
        )
        metrics, td = tt._train_steps_impl({key: torch.from_numpy(v) for key, v in stacked.items()})
        assert td.shape == (k, 16)
        for key, ref in jmetrics.items():
            np.testing.assert_allclose(metrics[key].numpy(), np.asarray(ref), rtol=1e-4, err_msg=key)
        np.testing.assert_allclose(td.numpy(), np.asarray(jtd), rtol=1e-4)
        _assert_params(tt, jstate.params, 1e-3, k)
        _assert_moments(tt, jstate.opt_state)
        assert tt.global_step == k
        # The module stays in eval mode with no graph between steps.
        assert not tt.model.training
        assert all(p.grad is None for p in tt.model.parameters())


class TestDropout:
    def test_train_mode_without_dropout_matches_flax_layer(self):
        dim, heads, mlp = 12, 2, 16
        jl = JaxLayer(dim, heads, mlp, jax.nn.relu, jnp.float32, dropout_rate=0.0)
        x = np.random.default_rng(0).normal(size=(3, 6, dim)).astype(np.float32)
        variables = jl.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
        want = jl.apply(variables, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(1)})
        layer = TransformerEncoderLayer(dim, heads, mlp, torch.relu, torch.float32, dropout_rate=0.0)
        state = {
            k.split(".", 1)[1]: v for k, v in flax_to_torch(
                {"params": {"L": jax.tree_util.tree_map(np.asarray, variables["params"])}}
            ).items()
        }
        layer.load_state_dict(state)
        layer.train()
        got = layer(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        # With dropout on, eval mode is the identity of dropout.
        layer.dropout_rate = 0.1
        layer.eval()
        np.testing.assert_allclose(layer(torch.from_numpy(x)).detach().numpy(), np.asarray(want), atol=1e-5)
        layer.train()
        with pytest.raises(ValueError, match="Generator"):
            layer(torch.from_numpy(x))
        gen = torch.Generator().manual_seed(0)
        assert not torch.allclose(layer(torch.from_numpy(x), gen), got)

    def test_keep_rate_and_scale(self):
        x = torch.ones(400_000)
        gen = torch.Generator().manual_seed(3)
        y = dropout(x, 0.1, gen)
        kept = y != 0
        assert abs(kept.float().mean().item() - 0.9) < 0.003
        torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
        again = dropout(x, 0.1, torch.Generator().manual_seed(3))
        assert torch.equal(y, again)  # the generator fixes the mask
