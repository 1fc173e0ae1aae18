"""Parity of the PyTorch port's self-play (`rl/self_play.py`) and its
action rule (`mcts.helpers.select_action_from_visits`) with the JAX
package.

The port draws its Gumbel and gamma noise through two functions of its
`rng`; these tests route both through `jax.random` for the same key, so
the searches and the action draws see the same noise. A stub net whose
outputs are exact stands in for the net on both sides, so a chunk of
several moves must agree exactly: actions, rewards, episode ends and
stats, resets, and the matured and flushed rows and their masks. The
n-step returns and root values take float sums in another order and
agree within 1e-5. The scalar features (`other`) agree within one ulp:
inside the jitted chunk XLA rewrites the bumpiness feature's chain of
divisions by constants (eager JAX and the port agree exactly,
`test_torch_env.py`).
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alphatriangle_tpu.config import AlphaTriangleMCTSConfig  # noqa: E402
from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.mcts.helpers import select_action_from_visits as jax_select  # noqa: E402
from alphatriangle_tpu.rl.self_play import SelfPlayEngine as JaxEngine  # noqa: E402
from alphatriangle_tpu.telemetry import device_stats as jds  # noqa: E402
from alphatriangle_tpu_torch.env import TriangleEnv  # noqa: E402
from alphatriangle_tpu_torch.features import FeatureExtractor  # noqa: E402
from alphatriangle_tpu_torch.mcts import select_action_from_visits  # noqa: E402
from alphatriangle_tpu_torch.nn.network import LiveWeights  # noqa: E402
from alphatriangle_tpu_torch.nn.model import value_support  # noqa: E402
from alphatriangle_tpu_torch.ops import KERNELS  # noqa: E402
from alphatriangle_tpu_torch.rl import SelfPlayEngine  # noqa: E402
from alphatriangle_tpu_torch.telemetry.device_stats import SEARCH_PACK_SIZE  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import default_device_stats  # noqa: E402
from torch_parity import (  # noqa: E402
    CPU,
    JaxExactStub,
    TorchExactStub,
    assert_stat_packs,
    device_stats_on,
    inject_jax_noise,
    small_model_config,
    stub_net,
    to_torch_state,
    torch_cfg,
    torch_key,
)

SUM_ATOL = 1e-5  # returns and root values: float sums in another order
ULP_RTOL = 2.5e-7  # one float32 ulp: XLA's rewrite of a feature's divisions
# The configuration the chunk and harvest tests share, so that the JAX
# engines compile its chunk program once.
SHARED = (dict(N_STEP_RETURNS=2, MAX_EPISODE_MOVES=30, TEMPERATURE_ANNEAL_MOVES=4), 5,
          dict(max_simulations=8, max_depth=4, mcts_batch_size=4))


@pytest.fixture(autouse=True)
def _jax_noise(monkeypatch):
    inject_jax_noise(monkeypatch)


class TestSelectAction:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_jax(self, seed):
        pick = np.random.default_rng(seed)
        counts = pick.integers(0, 6, (40, 25)).astype(np.float32)
        counts[3] = 0.0  # no visits: the -1 sentinel
        counts[7, [2, 9]] = 11.0  # a tie under greedy play: the first maximum
        temps = pick.random(40).astype(np.float32)
        temps[:8] = 0.0  # greedy rows
        temps[8] = 5e-9  # under the 1e-8 greedy threshold
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_select(jnp.asarray(counts), jnp.asarray(temps), key))
        got = select_action_from_visits(torch.from_numpy(counts), torch.from_numpy(temps), torch_key(key))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert want[3] == -1 and want[7] == 2
        scalar = select_action_from_visits(torch.from_numpy(counts), 1.0, torch_key(key))
        np.testing.assert_array_equal(scalar.numpy(), np.asarray(jax_select(counts, 1.0, key)))


@pytest.fixture(scope="module")
def compiled() -> dict:
    """Configuration -> the first JAX engine built for it, whose compiled
    chunk programs later engines of that configuration share."""
    return {}


def _engines(jenv_cfg, train_kw: dict, batch: int, mcts_kw: dict, compiled=None, stats=False):
    """(JAX engine, port engine) over the exact stub net; with
    `compiled=None` the port engine alone (JAX engine None). JAX engines
    of one configuration share their compiled chunk programs. `stats`
    builds both with their device stat-packs on."""
    if stats:
        with device_stats_on():
            return _engines(jenv_cfg, train_kw, batch, mcts_kw, compiled)
    model_cfg = small_model_config(jenv_cfg)
    mcts_cfg = AlphaTriangleMCTSConfig(**mcts_kw)
    jcfg = JaxTrainConfig(AUTO_RESUME_LATEST=False, RUN_NAME="sp", **train_kw)
    adim, atoms = jenv_cfg.action_dim, model_cfg.NUM_VALUE_ATOMS
    support = value_support(torch_cfg(model_cfg))
    jeng = None
    if compiled is not None:
        jenv = JaxEnv(jenv_cfg)
        jnet = SimpleNamespace(
            model=JaxExactStub(adim, atoms), support=jnp.asarray(support.numpy()),
            weights_version=3, variables={},
        )
        key = repr((jenv_cfg, sorted(train_kw.items()), batch, sorted(mcts_kw.items()),
                    jds.device_stats_enabled()))
        jeng = JaxEngine(
            jenv, get_feature_extractor(jenv, model_cfg), jnet, mcts_cfg, jcfg, batch_size=batch,
            seed=9, share_compiled=compiled.get(key),
        )
        compiled.setdefault(key, jeng)
    tenv = TriangleEnv(torch_cfg(jenv_cfg), device=CPU)
    tnet = stub_net(TorchExactStub(adim, atoms), support)
    teng = SelfPlayEngine(
        tenv, FeatureExtractor(tenv, torch_cfg(model_cfg)), tnet, torch_cfg(mcts_cfg),
        torch_cfg(jcfg), batch_size=batch, seed=9,
    )
    return jeng, teng


def _assert_tree(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree(got[k], want[k], f"{path}/{k}")
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, path
    if path.endswith(("/ret", "/root_value")):
        np.testing.assert_allclose(got, want, rtol=0, atol=SUM_ATOL, err_msg=path)
    elif path.endswith("/other"):
        np.testing.assert_allclose(got, want, rtol=ULP_RTOL, atol=0, err_msg=path)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=path)


CHUNK_CASES = [("tiny", 2, 6, 30), ("tiny", 3, 8, 4), ("flagship", 3, 4, 1000)]


@pytest.fixture(scope="module")
def chunk_engines(tiny_env_config, compiled) -> dict:
    """Each chunk case's (JAX engine, port engine). The JAX chunk
    programs compile together, in threads (XLA compiles outside the GIL),
    before the first case runs."""
    default_device_stats()  # a search reads the stat-pack flag when built
    from alphatriangle_tpu.config import EnvConfig

    pairs = {}
    for board, n, moves, cap in CHUNK_CASES:
        pairs[(board, n, moves, cap)] = _engines(
            tiny_env_config if board == "tiny" else EnvConfig(),
            dict(N_STEP_RETURNS=n, MAX_EPISODE_MOVES=cap, TEMPERATURE_ANNEAL_MOVES=4),
            5 if board == "tiny" else 3,
            dict(max_simulations=8, max_depth=4, mcts_batch_size=4),
            compiled,
            stats=True,
        )
    with ThreadPoolExecutor(len(pairs)) as pool:
        assert all(pool.map(lambda case: pairs[case][0].warm_chunk(case[2]), pairs))
    return pairs


class TestChunk:
    @pytest.mark.parametrize("board,n,moves,cap", CHUNK_CASES)
    def test_chunk_matches_jax(self, chunk_engines, board, n, moves, cap):
        jeng, teng = chunk_engines[(board, n, moves, cap)]
        jcarry, jout = jeng._chunk_fn(moves)({}, jeng._carry, jnp.int32(11))
        before = {k: v.launches for k, v in KERNELS.items()}
        tcarry, tout = teng._chunk(moves, teng._carry, LiveWeights(11, teng.net.model))
        assert {k: v.launches for k, v in KERNELS.items()} == before  # CPU: plain versions
        jout = jax.device_get(jout)
        jout["trace"] = {k: jout["trace"][k] for k in tout["trace"]}
        # The moves' stat-packs, stacked over the chunk on both sides.
        assert jeng.device_stats and teng.device_stats
        assert tuple(tout["device_stats"].shape) == (moves, SEARCH_PACK_SIZE)
        assert_stat_packs(tout.pop("device_stats"), jout.pop("device_stats"), board)
        # Episodes carry the version they started under: the engine's
        # initial one (3), or this chunk's (11) for those it reset.
        _assert_tree(tout, jout)
        assert bool(jout["episode"]["ending"].any()) or board == "flagship"
        # The carries agree too: games, windows and the key.
        _assert_tree(to_torch_state(jcarry.env).__dict__, tcarry.env.__dict__)
        for name in ("pend_grid", "pend_policy", "pend_active"):
            np.testing.assert_array_equal(getattr(tcarry, name).numpy(), np.asarray(getattr(jcarry, name)))
        np.testing.assert_allclose(
            tcarry.pend_other.numpy(), np.asarray(jcarry.pend_other), rtol=ULP_RTOL, atol=0
        )
        np.testing.assert_allclose(
            tcarry.pend_return.numpy(), np.asarray(jcarry.pend_return), atol=SUM_ATOL
        )
        np.testing.assert_array_equal(tcarry.rng.numpy(), np.asarray(jcarry.rng).astype(np.int64))
        np.testing.assert_array_equal(
            tcarry.episode_start_version.numpy(), np.asarray(jcarry.episode_start_version)
        )
        assert tcarry.move_index == int(jcarry.move_index)

    def test_harvest_matches_jax(self, tiny_env_config, compiled):
        jeng, teng = _engines(tiny_env_config, *SHARED, compiled)
        for _ in range(2):
            want, got = jeng.play_moves(6), teng.play_moves(6)
            assert got.num_experiences == want.num_experiences > 0
            for name in ("grid", "policy_target", "policy_weight"):
                np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
            np.testing.assert_allclose(got.other_features, want.other_features, rtol=ULP_RTOL, atol=0)
            np.testing.assert_allclose(got.value_target, want.value_target, atol=SUM_ATOL)
            for name in (
                "episode_scores", "episode_lengths", "num_episodes", "num_truncated",
                "total_simulations", "episode_start_versions", "trainer_step_at_episode_start",
            ):
                assert getattr(got, name) == getattr(want, name), name
        for name in ("root_value", "reward", "ending", "wasted_slots", "sims"):
            np.testing.assert_allclose(teng.last_trace[name], jeng.last_trace[name], atol=SUM_ATOL)

    def test_device_payload_matches_fetched_rows(self, tiny_env_config):
        _, teng = _engines(
            tiny_env_config, dict(N_STEP_RETURNS=2), 3,
            dict(max_simulations=4, max_depth=3, mcts_batch_size=2),
        )
        result, payload = teng.play_moves_device(4)
        assert result.num_experiences == 0
        assert payload["mat"]["mask"].shape == (4, 3)
        assert payload["flush"]["mask"].shape == (4, 3, 2)
