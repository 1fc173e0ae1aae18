"""Parity of the PyTorch port's features and network with the JAX
package.

- Features: exact in float32.
- Network, after `flax_to_torch` of the Flax variables: the float32
  forward within 1e-5 (absolute and relative; the two frameworks sum
  matmuls, convolutions and norm statistics in other orders). The
  bfloat16 forward within the tolerance `tests/test_ops.py::
  TestInferencePrecision` holds the JAX package's own bf16 path to
  against f32: policy probabilities within 0.05, expected values within
  0.2 absolute plus 0.1 relative (bf16 keeps 8 bits of mantissa, and
  the two frameworks round at other places).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alphatriangle_tpu.config import EnvConfig, ModelConfig  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import (  # noqa: E402
    build_shape_feature_table as jax_shape_table,
)
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.nn.model import expected_value_from_logits as jax_expected  # noqa: E402
from alphatriangle_tpu.nn.model import value_support as jax_support  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu_torch.env import TriangleEnv  # noqa: E402
from alphatriangle_tpu_torch.features import (  # noqa: E402
    FeatureExtractor,
    build_shape_feature_table,
)
from alphatriangle_tpu_torch.nn import (  # noqa: E402
    NetworkEvaluationError,
    NeuralNetwork,
    expected_value_from_logits,
    flax_to_torch,
    value_support,
)
from torch_parity import CPU, converted_state_dict, small_model_config, torch_cfg  # noqa: E402

F32_TOL = 1e-5
BF16_PROB_ATOL = 0.05
BF16_VALUE_ATOL, BF16_VALUE_RTOL = 0.2, 0.1


def _played_states(jenv, batch: int, moves: int, seed: int):
    """Batched JAX states some random legal moves into their games."""
    states = jenv.reset_batch(jax.random.split(jax.random.PRNGKey(seed), batch))
    pick = np.random.default_rng(seed)
    out = [states]
    for _ in range(moves):
        mask = np.asarray(jenv.valid_mask_batch(states))
        acts = np.array([pick.choice(np.flatnonzero(m)) if m.any() else 0 for m in mask])
        states, _, _ = jenv.step_batch(states, jnp.asarray(acts, jnp.int32))
        out.append(states)
    return jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs), *out)


@pytest.fixture(params=["tiny", "flagship"])
def env_pair(request, tiny_env_config):
    jcfg = tiny_env_config if request.param == "tiny" else EnvConfig()
    return jcfg, torch_cfg(jcfg)


class TestFeatures:
    def test_shape_table_equal(self, env_pair):
        jcfg, cfg = env_pair
        tenv = TriangleEnv(cfg, device=CPU)
        np.testing.assert_array_equal(
            build_shape_feature_table(tenv.bank, cfg),
            jax_shape_table(JaxEnv(jcfg).bank, jcfg),
        )

    def test_extract_exact(self, env_pair):
        from torch_parity import to_torch_state

        jcfg, cfg = env_pair
        jenv = JaxEnv(jcfg)
        model_cfg = small_model_config(jcfg, GRID_INPUT_CHANNELS=2)
        jfe = get_feature_extractor(jenv, model_cfg)
        tfe = FeatureExtractor(TriangleEnv(cfg, device=CPU), torch_cfg(model_cfg))
        states = _played_states(jenv, 6, moves=8, seed=3)
        jgrid, jother = jax.vmap(jfe.extract)(states)
        tgrid, tother = tfe.extract(to_torch_state(states))
        assert tother.shape[-1] == model_cfg.OTHER_NN_INPUT_FEATURES_DIM
        np.testing.assert_array_equal(tgrid.numpy(), np.asarray(jgrid))
        np.testing.assert_array_equal(tother.numpy(), np.asarray(jother))

    def test_feature_dim_mismatch_raises(self, tiny_env_config):
        model_cfg = torch_cfg(small_model_config(tiny_env_config, OTHER_NN_INPUT_FEATURES_DIM=5))
        with pytest.raises(ValueError, match="OTHER_NN_INPUT_FEATURES_DIM"):
            FeatureExtractor(TriangleEnv(torch_cfg(tiny_env_config), device=CPU), model_cfg)


def _inputs(model_cfg, env_cfg, batch: int = 24, seed: int = 0):
    pick = np.random.default_rng(seed)
    grid = (pick.random((batch, model_cfg.GRID_INPUT_CHANNELS, env_cfg.ROWS, env_cfg.COLS)) < 0.5)
    other = pick.random((batch, model_cfg.OTHER_NN_INPUT_FEATURES_DIM))
    return grid.astype(np.float32), other.astype(np.float32)


def _pair(env_cfg, model_cfg, seed: int = 3):
    jnet = JaxNetwork(model_cfg, env_cfg, seed=seed)
    tnet = NeuralNetwork(
        torch_cfg(model_cfg), torch_cfg(env_cfg), state_dict=converted_state_dict(jnet),
        device=CPU,
    )
    return jnet, tnet


NET_VARIANTS = {
    "group-gelu": {},
    "layer-relu": {"NORM_TYPE": "layer", "ACTIVATION_FUNCTION": "ReLU"},
    "strided": {"CONV_STRIDES": [2, 1], "CONV_KERNEL_SIZES": [3, 3]},
    "no-transformer": {"USE_TRANSFORMER": False, "TRANSFORMER_LAYERS": 0},
    "batch-silu": {"NORM_TYPE": "batch", "ACTIVATION_FUNCTION": "SiLU"},
    "two-layers-4-heads": {"TRANSFORMER_LAYERS": 2, "TRANSFORMER_HEADS": 4},
}


class TestNetwork:
    @pytest.mark.parametrize("variant", sorted(NET_VARIANTS))
    def test_f32_forward_matches_flax(self, tiny_env_config, variant):
        model_cfg = small_model_config(tiny_env_config, **NET_VARIANTS[variant])
        jnet, tnet = _pair(tiny_env_config, model_cfg)
        grid, other = _inputs(model_cfg, tiny_env_config)
        jp, jv = jnet.model.apply(jnet.variables, grid, other, train=False)
        tp, tv = tnet.model(torch.from_numpy(grid), torch.from_numpy(other))
        assert tp.dtype == tv.dtype == torch.float32
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=F32_TOL, atol=F32_TOL)

    @pytest.mark.parametrize("norm", ["group", "layer"])
    def test_bf16_forward_matches_flax(self, tiny_env_config, norm):
        model_cfg = small_model_config(tiny_env_config, COMPUTE_DTYPE="bfloat16", NORM_TYPE=norm)
        jnet, tnet = _pair(tiny_env_config, model_cfg)
        grid, other = _inputs(model_cfg, tiny_env_config)
        jp, jv = jnet.model.apply(jnet.variables, grid, other, train=False)
        tp, tv = tnet.model(torch.from_numpy(grid), torch.from_numpy(other))
        assert tp.dtype == tv.dtype == torch.float32  # heads stay f32
        np.testing.assert_allclose(
            torch.softmax(tp, -1).numpy(), np.asarray(jax.nn.softmax(jp, -1)),
            atol=BF16_PROB_ATOL,
        )
        support = value_support(tnet.model_config)
        np.testing.assert_allclose(
            expected_value_from_logits(tv, support).numpy(),
            np.asarray(jax_expected(jv, jnet.support)),
            atol=BF16_VALUE_ATOL, rtol=BF16_VALUE_RTOL,
        )

    def test_flagship_default_net_converts(self):
        """The default 8x15 net, at float32, loads its Flax weights with
        every parameter accounted for, and agrees within 1e-5."""
        env_cfg = EnvConfig()
        model_cfg = ModelConfig(COMPUTE_DTYPE="float32")
        jnet = JaxNetwork(model_cfg, env_cfg, seed=1)
        state = converted_state_dict(jnet)
        tnet = NeuralNetwork(torch_cfg(model_cfg), torch_cfg(env_cfg), device=CPU)
        assert set(state) == set(tnet.model.state_dict())
        tnet.set_weights(state)
        grid, other = _inputs(model_cfg, env_cfg, batch=4)
        jp, jv = jnet.model.apply(jnet.variables, grid, other, train=False)
        tp, tv = tnet.model(torch.from_numpy(grid), torch.from_numpy(other))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=F32_TOL, atol=F32_TOL)

    def test_value_support_and_expectation(self, tiny_env_config):
        model_cfg = small_model_config(tiny_env_config, VALUE_MIN=-7.5, VALUE_MAX=13.0)
        support = value_support(torch_cfg(model_cfg))
        # One ulp: XLA:CPU fuses jnp.linspace into one loop whose
        # division is not correctly rounded; the port's is.
        np.testing.assert_allclose(
            support.numpy(), np.asarray(jax_support(model_cfg)), rtol=0, atol=1e-6
        )
        logits = np.random.default_rng(2).standard_normal((5, 11)).astype(np.float32)
        np.testing.assert_allclose(
            expected_value_from_logits(torch.from_numpy(logits), support).numpy(),
            np.asarray(jax_expected(logits, jax_support(model_cfg))),
            rtol=1e-6, atol=1e-6,
        )

    def test_evaluate_set_weights_and_version(self, tiny_env_config):
        model_cfg = small_model_config(tiny_env_config)
        jnet, tnet = _pair(tiny_env_config, model_cfg)
        grid, other = _inputs(model_cfg, tiny_env_config, batch=6)
        jprobs, jvalues = jnet.evaluate_features(grid, other)
        tprobs, tvalues = tnet.evaluate_features(torch.from_numpy(grid), torch.from_numpy(other))
        np.testing.assert_allclose(tprobs.numpy(), jprobs, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(tvalues.numpy(), jvalues, rtol=F32_TOL, atol=F32_TOL)

        other_net = NeuralNetwork(
            torch_cfg(model_cfg), torch_cfg(tiny_env_config), seed=9, device=CPU
        )
        assert tnet.weights_version == 0
        tnet.set_weights(other_net.get_weights())
        assert tnet.weights_version == 1
        probs, _ = tnet.evaluate_features(torch.from_numpy(grid), torch.from_numpy(other))
        want, _ = other_net.evaluate_features(torch.from_numpy(grid), torch.from_numpy(other))
        assert torch.equal(probs, want)

        broken = tnet.get_weights()
        broken["MLPHead_0.Dense_1.bias"][:] = float("nan")
        tnet.set_weights(broken)
        with pytest.raises(NetworkEvaluationError):
            tnet.evaluate_features(torch.from_numpy(grid), torch.from_numpy(other))

    def test_converter_rejects_unknown_leaves(self):
        with pytest.raises(ValueError, match="unexpected Flax leaf"):
            flax_to_torch({"params": {"Dense_0": {"embedding": np.zeros((2, 2))}}})
