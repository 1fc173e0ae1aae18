"""Parity of the PyTorch port's configs, tables, random streams and
engine with the JAX package: all exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alphatriangle_tpu.config import (  # noqa: E402
    AlphaTriangleMCTSConfig,
    EnvConfig,
    ModelConfig,
    expected_other_features_dim,
)
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.env.engine import _build_bit_tables as jax_bit_tables  # noqa: E402
from alphatriangle_tpu.env.geometry import build_geometry as jax_geometry  # noqa: E402
from alphatriangle_tpu.env.shapes import build_shape_bank as jax_bank  # noqa: E402
from alphatriangle_tpu_torch import config as tcfg  # noqa: E402
from alphatriangle_tpu_torch import rng  # noqa: E402
from alphatriangle_tpu_torch.env import engine as tengine  # noqa: E402
from alphatriangle_tpu_torch.env.geometry import build_geometry  # noqa: E402
from alphatriangle_tpu_torch.env.shapes import build_shape_bank  # noqa: E402

CPU = "cpu"


def _torch_env_cfg(jax_cfg) -> "tcfg.EnvConfig":
    return tcfg.EnvConfig(**jax_cfg.model_dump())


# --- configs ------------------------------------------------------------


class TestConfigs:
    @pytest.mark.parametrize(
        "jax_cls,torch_cls",
        [
            (EnvConfig, tcfg.EnvConfig),
            (ModelConfig, tcfg.ModelConfig),
            (AlphaTriangleMCTSConfig, tcfg.AlphaTriangleMCTSConfig),
        ],
    )
    def test_defaults_dump_equal(self, jax_cls, torch_cls):
        assert torch_cls().model_dump() == jax_cls().model_dump()

    def test_tiny_dumps_load_unchanged(
        self, tiny_env_config, tiny_model_config, tiny_mcts_config
    ):
        for cfg, cls in (
            (tiny_env_config, tcfg.EnvConfig),
            (tiny_model_config, tcfg.ModelConfig),
            (tiny_mcts_config, tcfg.AlphaTriangleMCTSConfig),
        ):
            dump = cfg.model_dump()
            assert cls.model_validate(dump).model_dump() == dump
            assert cls(**dump).model_dump() == dump

    def test_kernel_knobs_accept_jax_modes_and_reject_others(self):
        for mode in ("einsum", "pallas", "take"):
            tcfg.AlphaTriangleMCTSConfig(descent_gather=mode)
        for mode in ("xla", "pallas"):
            tcfg.AlphaTriangleMCTSConfig(backup_update=mode, tree_reuse_backend=mode)
        with pytest.raises(ValueError):
            tcfg.AlphaTriangleMCTSConfig(descent_gather="cuda")
        with pytest.raises(ValueError):
            tcfg.AlphaTriangleMCTSConfig(backup_update="x")

    def test_validators_match(self):
        with pytest.raises(ValueError):
            tcfg.EnvConfig(ROWS=2)
        with pytest.raises(ValueError):
            tcfg.ModelConfig(TRANSFORMER_DIM=10, TRANSFORMER_HEADS=4)
        with pytest.raises(ValueError):
            tcfg.ModelConfig(VALUE_MIN=1.0, VALUE_MAX=1.0)
        with pytest.raises(ValueError):
            tcfg.AlphaTriangleMCTSConfig(max_simulations=8, fast_simulations=8)
        assert (
            tcfg.ModelConfig.model_validate({"USE_BATCH_NORM": False}).NORM_TYPE
            == ModelConfig(USE_BATCH_NORM=False).NORM_TYPE
        )

    @pytest.mark.parametrize("slots", [1, 3])
    def test_feature_dim_helper(self, slots):
        jcfg = EnvConfig(NUM_SHAPE_SLOTS=slots)
        assert tcfg.expected_other_features_dim(
            _torch_env_cfg(jcfg)
        ) == expected_other_features_dim(jcfg)


# --- static tables ------------------------------------------------------


@pytest.fixture(params=["tiny", "flagship"])
def env_pair(request, tiny_env_config):
    jcfg = tiny_env_config if request.param == "tiny" else EnvConfig()
    return jcfg, _torch_env_cfg(jcfg)


class TestTables:
    def test_shape_bank_equal(self, env_pair):
        jcfg, cfg = env_pair
        a, b = jax_bank(jcfg), build_shape_bank(cfg)
        for name in ("tri_r", "tri_c", "tri_up", "tri_valid", "n_tris"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert a.shapes == b.shapes

    def test_geometry_equal(self, env_pair):
        jcfg, cfg = env_pair
        a, b = jax_geometry(jcfg), build_geometry(cfg)
        for name in ("death", "up", "line_masks"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))

    def test_bit_tables_equal(self, env_pair):
        jcfg, cfg = env_pair
        a = jax_bit_tables(jcfg, jax_bank(jcfg), jax_geometry(jcfg))
        b = tengine._build_bit_tables(cfg, build_shape_bank(cfg), build_geometry(cfg))
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(x, y)


# --- threefry -----------------------------------------------------------


def _np(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


class TestThreefry:
    @pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
    def test_prng_key(self, seed):
        np.testing.assert_array_equal(
            rng.PRNGKey(seed).numpy(), _np(jax.random.PRNGKey(seed))
        )

    @pytest.mark.parametrize("num", [2, 3, 7])
    def test_split(self, num):
        jk = jax.random.PRNGKey(17)
        np.testing.assert_array_equal(
            rng.split(rng.PRNGKey(17), num).numpy(), _np(jax.random.split(jk, num))
        )

    def test_batched_split_matches_vmap(self):
        jkeys = jax.random.split(jax.random.PRNGKey(5), 6)
        got = rng.split(torch.from_numpy(_np(jkeys)), 3).numpy()
        want = _np(jax.vmap(lambda k: jax.random.split(k, 3))(jkeys))
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("data", [0, 1, 63, 2**32 - 1])
    def test_fold_in(self, data):
        jk = jax.random.PRNGKey(3)
        np.testing.assert_array_equal(
            rng.fold_in(rng.PRNGKey(3), data).numpy(),
            _np(jax.random.fold_in(jk, data)),
        )

    def test_bits(self):
        jk = jax.random.PRNGKey(9)
        np.testing.assert_array_equal(
            rng.bits(rng.PRNGKey(9), (4, 5)).numpy(),
            _np(jax.random.bits(jk, (4, 5), dtype=jnp.uint32)),
        )

    @pytest.mark.parametrize("lo,hi", [(0, 61), (0, 7), (-3, 1000), (5, 5)])
    def test_randint(self, lo, hi):
        jk = jax.random.PRNGKey(11)
        np.testing.assert_array_equal(
            rng.randint(rng.PRNGKey(11), (3, 8), lo, hi).numpy(),
            np.asarray(jax.random.randint(jk, (3, 8), lo, hi)),
        )

    def test_batched_randint_matches_vmap(self):
        jkeys = jax.random.split(jax.random.PRNGKey(2), 5)
        got = rng.randint(torch.from_numpy(_np(jkeys)), (3,), 0, 61).numpy()
        want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (3,), 0, 61))(jkeys))
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize(
        "lo,hi", [(0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0), (-2.0, 3.0)]
    )
    def test_uniform(self, lo, hi):
        jk = jax.random.PRNGKey(21)
        got = rng.uniform(rng.PRNGKey(21), (6, 7), lo, hi).numpy()
        want = np.asarray(jax.random.uniform(jk, (6, 7), minval=lo, maxval=hi))
        np.testing.assert_array_equal(got, want)

    def test_gumbel_and_gamma_are_close_in_distribution(self):
        g = rng.gumbel(rng.PRNGKey(1), (4000,)).numpy()
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(1), (4000,)))
        # Same uniforms, logarithms differing in the last bits only.
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5)
        draws = rng.gamma(rng.PRNGKey(4), 0.3, (20000,)).numpy()
        assert draws.min() >= 0.0
        assert abs(draws.mean() - 0.3) < 0.02
        again = rng.gamma(rng.PRNGKey(4), 0.3, (20000,)).numpy()
        np.testing.assert_array_equal(draws, again)


# --- engine -------------------------------------------------------------


_FIELDS = (
    "occupied",
    "color",
    "shape_idx",
    "shape_color",
    "score",
    "step_count",
    "done",
    "last_cleared",
    "key",
)


def _assert_state_equal(tstate, jstate):
    for name in _FIELDS:
        got = getattr(tstate, name).numpy()
        want = np.asarray(getattr(jstate, name))
        if name in ("occupied", "key"):
            want = want.astype(np.int64)
        np.testing.assert_array_equal(got, want, err_msg=name)


class TestEngine:
    def test_reset_step_mask_bit_exact(self, env_pair):
        jcfg, cfg = env_pair
        jenv, tenv = JaxEnv(jcfg), tengine.TriangleEnv(cfg, device=CPU)
        batch = 6
        jkeys = jax.random.split(jax.random.PRNGKey(7), batch)
        js = jenv.reset_batch(jkeys)
        ts = tenv.reset(torch.from_numpy(_np(jkeys)))
        _assert_state_equal(ts, js)
        pick = np.random.default_rng(0)
        steps = 12 if jcfg.ROWS == 3 else 24
        for t in range(steps):
            jmask = np.asarray(jenv.valid_mask_batch(js))
            np.testing.assert_array_equal(tenv.valid_action_mask(ts).numpy(), jmask)
            actions = np.zeros(batch, np.int32)
            for b in range(batch):
                legal = np.flatnonzero(jmask[b])
                if legal.size and not (t == 5 and b == 0):
                    actions[b] = pick.choice(legal)
                else:
                    # Forfeit path (illegal action) and finished games.
                    actions[b] = pick.integers(0, jcfg.action_dim)
            js, jr, jd = jenv.step_batch(js, jnp.asarray(actions))
            ts, tr, td = tenv.step(ts, torch.from_numpy(actions))
            _assert_state_equal(ts, js)
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))

    def test_reset_where_done(self, tiny_env_config):
        jenv = JaxEnv(tiny_env_config)
        tenv = tengine.TriangleEnv(_torch_env_cfg(tiny_env_config), device=CPU)
        jkeys = jax.random.split(jax.random.PRNGKey(1), 4)
        js = jenv.reset_batch(jkeys)
        js = js.replace(done=jnp.asarray([True, False, True, False]))
        ts = tenv.reset(torch.from_numpy(_np(jkeys)))
        ts = ts.replace(done=torch.tensor([True, False, True, False]))
        jout = jenv.reset_where_done_jit(js, jax.random.PRNGKey(8))
        tout = tenv.reset_where_done(ts, rng.PRNGKey(8))
        _assert_state_equal(tout, jout)

    def test_popcount(self):
        x = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000001, 0x12345678])
        want = [bin(v).count("1") for v in x.tolist()]
        assert tengine.popcount32(x).tolist() == want

    def test_requires_card_unless_cpu(self, tiny_env_config, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            tengine.TriangleEnv(_torch_env_cfg(tiny_env_config))
