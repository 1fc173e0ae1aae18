"""The PyTorch port's inference precision policy (`nn/precision.py`)
against the JAX package's (`alphatriangle_tpu/nn/precision.py`).

- Exact, for every leaf of the default `ModelConfig()` net (the q/k/v
  kernels and their `(H, hd)` biases included): the bf16 leaves and the
  int8 `q` / `scale` of `cast_params_for_inference`, through
  `flax_inference_to_torch`; their dequantization, leaf by leaf and
  packed by row length; `quantized_param_bytes`. The float32 policy is
  the identity (the same object).
- Within the bf16 tolerances of `torch_parity.py`: the bf16 and int8
  forwards of a small net in bf16 compute against Flax on the same cast
  variables; with float32 compute the int8 forward reads the same
  dequantized weights on both sides, so it agrees within 1e-5, as the
  float32 forward does. BatchNorm in eval mode with bf16 statistics
  (the whole norm in bf16, as Flax computes it) within one bf16 ulp of
  Flax's layer.
- The fixed-seed paired arena gate of `tests/test_ops.py` (bf16 and
  int8 against f32, within 3.0 points), played on the port.
- The memo: one `InferenceNet` per weights version of the net, shared
  by its callers; the service casts once per (version, reload count).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

from alphatriangle_tpu.config import EnvConfig, ModelConfig, expected_other_features_dim  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.nn.precision import cast_params_for_inference as jax_cast  # noqa: E402
from alphatriangle_tpu.nn.precision import dequantize_params as jax_dequantize  # noqa: E402
from alphatriangle_tpu.nn.precision import quantized_param_bytes as jax_bytes  # noqa: E402
from alphatriangle_tpu_torch import rng  # noqa: E402
from alphatriangle_tpu_torch.arena import greedy_mcts_policy, play  # noqa: E402
from alphatriangle_tpu_torch.env import TriangleEnv  # noqa: E402
from alphatriangle_tpu_torch.features import FeatureExtractor  # noqa: E402
from alphatriangle_tpu_torch.mcts import BatchedMCTS  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork, flax_inference_to_torch  # noqa: E402
from alphatriangle_tpu_torch.nn import precision  # noqa: E402
from alphatriangle_tpu_torch.nn.model import BatchNorm  # noqa: E402
from alphatriangle_tpu_torch.serving import PolicyService  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    BF16_PROB_ATOL,
    BF16_VALUE_ATOL,
    BF16_VALUE_RTOL,
    CPU,
    converted_state_dict,
    small_model_config,
    torch_cfg,
)

F32_TOL = 1e-5
BF16_ULP = 2.0**-7  # one bf16 ulp, relative
REDUCED = ("bfloat16", "int8")


def _with(cfg, precision_name: str):
    return cfg.model_copy(update={"INFERENCE_PRECISION": precision_name})


@pytest.fixture(scope="module")
def default_pair():
    """The default `ModelConfig()` net on the default board, on both sides."""
    env_cfg = EnvConfig()
    model_cfg = ModelConfig(OTHER_NN_INPUT_FEATURES_DIM=expected_other_features_dim(env_cfg))
    jnet = JaxNetwork(model_cfg, env_cfg, seed=3)
    tnet = NeuralNetwork(
        torch_cfg(model_cfg), torch_cfg(env_cfg), state_dict=converted_state_dict(jnet), device=CPU
    )
    return model_cfg, jnet, tnet


def _port_cast(tnet, model_cfg):
    return precision.cast_params_for_inference(tnet.model.state_dict(), torch_cfg(model_cfg))


def _jax_cast(jnet, model_cfg):
    return jax.tree_util.tree_map(np.asarray, jax_cast(jnet.variables, model_cfg))


def _assert_leaves_equal(got: dict, want: dict) -> int:
    """Leaf for leaf, bit for bit, dtypes and shapes included; returns
    the number of quantized leaves."""
    assert set(got) == set(want)
    quantized = 0
    for name, w in want.items():
        g = got[name]
        if precision.is_quantized_leaf(w):
            quantized += 1
            for part in ("q", "scale"):
                assert g[part].dtype == w[part].dtype and g[part].shape == w[part].shape, name
                assert torch.equal(g[part], w[part]), f"{name}.{part}"
        else:
            assert not precision.is_quantized_leaf(g), name
            assert g.dtype == w.dtype and torch.equal(g, w), name
    return quantized


class TestPolicy:
    def test_float32_is_the_identity(self, default_pair):
        model_cfg, _, tnet = default_pair
        state = tnet.model.state_dict()
        assert precision.cast_params_for_inference(state, torch_cfg(model_cfg)) is state
        assert precision.inference_dtype(torch_cfg(model_cfg)) == torch.float32
        assert tnet.inference_model() is tnet.model
        with pytest.raises(ValueError, match="float32"):
            precision.InferenceNet(tnet.model, torch_cfg(model_cfg))

    @pytest.mark.parametrize("name", REDUCED)
    def test_leaves_equal_jax_bit_for_bit(self, default_pair, name):
        model_cfg, jnet, tnet = default_pair
        cfg = _with(model_cfg, name)
        got, want = _port_cast(tnet, cfg), flax_inference_to_torch(_jax_cast(jnet, cfg))
        quantized = _assert_leaves_equal(got, want)
        if name == "bfloat16":
            assert quantized == 0 and all(v.dtype == torch.bfloat16 for v in got.values())
        else:
            # Every conv and dense kernel, the attention's q/k/v/out
            # kernels and the q/k/v biases of both transformer layers.
            qkv = [n for n in got if ".query." in n or ".key." in n or ".value." in n]
            assert len(qkv) == 2 * 3 * 2
            assert all(precision.is_quantized_leaf(got[n]) for n in qkv)
            assert got[qkv[0]]["scale"].shape in ((32, 1), (32,))  # one scale per hd, H = 4
            assert quantized == sum(v.ndim >= 2 for v in tnet.model.state_dict().values()) + 6
        assert precision.quantized_param_bytes(got) == jax_bytes(_jax_cast(jnet, cfg))

    def test_dequantization_equals_jax_bit_for_bit(self, default_pair):
        model_cfg, jnet, tnet = default_pair
        cfg = _with(model_cfg, "int8")
        leaves = _port_cast(tnet, cfg)
        want = flax_inference_to_torch(
            jax.tree_util.tree_map(np.asarray, jax_dequantize(jax_cast(jnet.variables, cfg)))
        )
        by_leaf = precision.dequantize_params(leaves)
        groups = precision.QuantizedGroups(leaves)
        packed = precision.dequantize_params(groups)
        assert groups.launches == 8  # one per row length of the default net
        for name, w in want.items():
            assert by_leaf[name].dtype == packed[name].dtype == w.dtype == torch.bfloat16, name
            assert torch.equal(by_leaf[name], w) and torch.equal(packed[name], w), name
        # The packed form holds the int8 bytes and one scale per row.
        assert groups.nbytes() - precision.quantized_param_bytes(leaves) == 4 * 3 * 2 * (128 - 32) * 2

    @pytest.mark.parametrize("compute", ["float32", "bfloat16"])
    def test_positional_is_not_cast(self, tiny_env_config, compute):
        cfg = torch_cfg(small_model_config(
            tiny_env_config, COMPUTE_DTYPE=compute, INFERENCE_PRECISION="int8"
        ))
        net = NeuralNetwork(cfg, torch_cfg(tiny_env_config), device=CPU)
        want = torch.float32 if compute == "float32" else torch.bfloat16
        assert "positional" not in precision.cast_params_for_inference(net.model.state_dict(), cfg)
        cast = net.inference_model()
        assert cast._template.positional.dtype == want
        assert torch.equal(cast._template.positional, net.model.positional)
        assert cast._template.dtype == net.model.dtype == want  # the compute dtype stays


def _inputs(model_cfg, env_cfg, batch: int = 24, seed: int = 0):
    pick = np.random.default_rng(seed)
    grid = (pick.random((batch, model_cfg.GRID_INPUT_CHANNELS, env_cfg.ROWS, env_cfg.COLS)) < 0.5)
    other = pick.random((batch, model_cfg.OTHER_NN_INPUT_FEATURES_DIM))
    return grid.astype(np.float32), other.astype(np.float32)


def _random_batch_stats(jnet, seed: int):
    """The JAX net with running statistics away from their init."""
    pick = np.random.default_rng(seed)

    def draw(path, x):
        v = pick.normal(size=x.shape).astype(np.float32) * 0.3
        return jnp.asarray(np.abs(v) + 0.5 if path[-1].key == "var" else v)

    stats = jax.tree_util.tree_map_with_path(draw, jnet.variables["batch_stats"])
    jnet.variables = {**jnet.variables, "batch_stats": stats}


class TestForward:
    @pytest.mark.parametrize("name", REDUCED)
    @pytest.mark.parametrize("norm", ["group", "batch"])
    def test_bf16_compute_forward_matches_flax(self, tiny_env_config, name, norm):
        model_cfg = small_model_config(
            tiny_env_config, COMPUTE_DTYPE="bfloat16", NORM_TYPE=norm, INFERENCE_PRECISION=name
        )
        jnet = JaxNetwork(model_cfg, tiny_env_config, seed=3)
        if norm == "batch":
            _random_batch_stats(jnet, seed=1)
        tnet = NeuralNetwork(
            torch_cfg(model_cfg), torch_cfg(tiny_env_config), state_dict=converted_state_dict(jnet),
            device=CPU,
        )
        grid, other = _inputs(model_cfg, tiny_env_config)
        _, jprobs, jvalues = jnet._apply_eval(jax_cast(jnet.variables, model_cfg), grid, other)
        tprobs, tvalues = tnet.evaluate_features(
            torch.from_numpy(grid), torch.from_numpy(other), model=tnet.inference_model()
        )
        np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=BF16_PROB_ATOL)
        np.testing.assert_allclose(
            tvalues.numpy(), np.asarray(jvalues), atol=BF16_VALUE_ATOL, rtol=BF16_VALUE_RTOL
        )

    @pytest.mark.parametrize("name", REDUCED)
    def test_f32_compute_forward_reads_the_same_weights(self, tiny_env_config, name):
        """With float32 compute both forwards promote the same bf16 (or
        dequantized int8) weights to f32: the float32 tolerance."""
        model_cfg = small_model_config(tiny_env_config, INFERENCE_PRECISION=name)
        jnet = JaxNetwork(model_cfg, tiny_env_config, seed=3)
        tnet = NeuralNetwork(
            torch_cfg(model_cfg), torch_cfg(tiny_env_config), state_dict=converted_state_dict(jnet),
            device=CPU,
        )
        grid, other = _inputs(model_cfg, tiny_env_config)
        _, jprobs, jvalues = jnet._apply_eval(jax_cast(jnet.variables, model_cfg), grid, other)
        _, f32_probs, _ = jnet._apply_eval(jnet.variables, grid, other)
        tprobs, tvalues = tnet.evaluate_features(
            torch.from_numpy(grid), torch.from_numpy(other), model=tnet.inference_model()
        )
        np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(tvalues.numpy(), np.asarray(jvalues), rtol=F32_TOL, atol=F32_TOL)
        # ... and the cast moved them: the comparison is not the f32 one.
        assert np.abs(np.asarray(jprobs) - np.asarray(f32_probs)).max() > 10 * F32_TOL

    @pytest.mark.parametrize("shape", [(6, 16), (3, 16, 3, 4)])
    def test_batch_norm_eval_in_bf16_matches_flax(self, shape):
        pick = np.random.default_rng(4)
        feats = 16
        bf16 = jnp.bfloat16
        x = jnp.asarray(pick.normal(size=shape).astype(np.float32) * 3 + 1).astype(bf16)
        variables = {
            "params": {
                "scale": jnp.asarray(pick.normal(size=feats).astype(np.float32)).astype(bf16),
                "bias": jnp.asarray(pick.normal(size=feats).astype(np.float32)).astype(bf16),
            },
            "batch_stats": {
                "mean": jnp.asarray(pick.normal(size=feats).astype(np.float32)).astype(bf16),
                "var": jnp.asarray(pick.random(feats).astype(np.float32) * 4 + 0.1).astype(bf16),
            },
        }
        layer = fnn.BatchNorm(use_running_average=True, dtype=bf16)
        x_nhwc = x if len(shape) == 2 else jnp.transpose(x, (0, 2, 3, 1))
        want = np.asarray(layer.apply(variables, x_nhwc).astype(jnp.float32))
        if len(shape) == 4:
            want = want.transpose(0, 3, 1, 2)
        bn = BatchNorm(feats, torch.bfloat16).eval()
        port = flax_inference_to_torch({"params": {"B": variables["params"]},
                                        "batch_stats": {"B": variables["batch_stats"]}})
        bn._parameters["weight"], bn._parameters["bias"] = port["B.weight"], port["B.bias"]
        bn._buffers["running_mean"], bn._buffers["running_var"] = (
            port["B.running_mean"], port["B.running_var"]
        )
        xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
        if len(shape) == 4:
            xt = xt.reshape(shape)
        got = bn(xt)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP, atol=1e-6)


def _arena_world(env_cfg, model_cfg, mcts_cfg, state_dict):
    env = TriangleEnv(torch_cfg(env_cfg), device=CPU)
    fe = FeatureExtractor(env, torch_cfg(model_cfg))
    net = NeuralNetwork(torch_cfg(model_cfg), torch_cfg(env_cfg), state_dict=state_dict, device=CPU)
    mcts = BatchedMCTS(env, fe, net.model, torch_cfg(mcts_cfg), net.support)
    return env, net, mcts


class TestArenaGate:
    @pytest.mark.parametrize("name", REDUCED)
    def test_fixed_seed_arena_within_gate(self, tiny_env_config, tiny_mcts_config, name):
        """`tests/test_ops.py`'s Elo-neutrality gate on the port: the
        same fixed-seed greedy games under f32 and reduced weights score
        within 3.0 points on average (paired hands strip the hand luck;
        a gap appears only where rounding flips a near-tie move)."""
        cfg = tiny_mcts_config.model_copy(update={"wave_noise_scale": 0.0})
        # The small net (groups of 8 features): the conftest's tiny net
        # outputs its output biases whatever its weights.
        net_cfg = small_model_config(tiny_env_config, USE_TRANSFORMER=False, TRANSFORMER_LAYERS=0)
        state = NeuralNetwork(
            torch_cfg(net_cfg), torch_cfg(tiny_env_config), seed=0, device=CPU
        ).get_weights()
        scores = {}
        for which in ("float32", name):
            model_cfg = _with(net_cfg, which)
            env, net, mcts = _arena_world(tiny_env_config, model_cfg, cfg, state)
            scores[which], _, _ = play(env, greedy_mcts_policy(net, mcts), games=4, max_moves=8, seed=21)
            assert isinstance(mcts.model, precision.InferenceNet) == (which != "float32")
        assert abs(float(scores[name].mean() - scores["float32"].mean())) <= 3.0


class TestMemo:
    def test_one_cast_per_weights_version(self, tiny_env_config):
        model_cfg = small_model_config(tiny_env_config, INFERENCE_PRECISION="int8")
        cfg = torch_cfg(model_cfg)
        net = NeuralNetwork(cfg, torch_cfg(tiny_env_config), device=CPU)
        before = precision.InferenceNet.casts
        first = net.inference_model()
        assert net.inference_model() is first and net.inference_model(net.live) is first
        assert precision.InferenceNet.casts == before + 1
        net.set_weights(net.get_weights())
        second = net.inference_model()
        assert second is not first and net.inference_model() is second
        assert precision.InferenceNet.casts == before + 2
        # A copy reads its version's weights, not the live ones after it.
        grid, other = _inputs(model_cfg, tiny_env_config, batch=4)
        g, o = torch.from_numpy(grid), torch.from_numpy(other)
        probs_first = net.evaluate_features(g, o, model=first)[0]
        state = net.get_weights()
        state = {k: v * 1.5 + 0.1 if v.is_floating_point() else v for k, v in state.items()}
        net.set_weights(state)
        assert torch.equal(net.evaluate_features(g, o, model=first)[0], probs_first)
        assert not torch.equal(net.evaluate_features(g, o, model=net.inference_model())[0], probs_first)

    def test_service_casts_once_per_version_and_reload(
        self, tiny_env_config, tiny_model_config, tiny_mcts_config
    ):
        model_cfg = _with(tiny_model_config, "bfloat16")
        env, net, mcts = _arena_world(tiny_env_config, model_cfg, tiny_mcts_config, None)
        service = PolicyService(env, FeatureExtractor(env, torch_cfg(model_cfg)), net, mcts, slots=2)
        (s,) = service.open_sessions(rng.split(rng.PRNGKey(3), 1))
        before = precision.InferenceNet.casts
        for _ in range(3):
            service.request_move(s.sid)
            assert service.dispatch()
        assert precision.InferenceNet.casts == before + 1
        assert isinstance(mcts.model, precision.InferenceNet)
        cast = mcts.model
        service.reload_weights()  # the same version, one reload more: cast again
        service.request_move(s.sid)
        service.dispatch()
        assert precision.InferenceNet.casts == before + 2 and mcts.model is not cast
        service.reload_weights(net.get_weights())
        service.request_move(s.sid)
        service.dispatch()
        assert precision.InferenceNet.casts == before + 3
