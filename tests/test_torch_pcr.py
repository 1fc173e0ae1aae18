"""Parity of the PyTorch port's playout-cap randomization and Gumbel
self-play (`rl/self_play.py`), and of serving with the Gumbel action
rule (`PolicyService` over a `GumbelMCTS`), with the JAX package.

The port draws its Gumbel and gamma noise through `jax.random` for the
same keys (`inject_jax_noise`); its per-move full/fast choice is
`rng.bernoulli` on the host, which is bit-exact with the JAX engine's
`jax.random.bernoulli` on the device. Under the exact stub net a chunk
must agree exactly: the `is_full` sequence and simulations per move,
actions, rewards, episode ends, the matured and flushed rows, their
masks and policy weights. Returns and root values take float sums in
another order (1e-5), the scalar features agree within one ulp, and the
Gumbel improved policy (a softmax in each framework) within 1e-6.
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alphatriangle_tpu.config import AlphaTriangleMCTSConfig  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.mcts.gumbel import GumbelMCTS as JaxGumbel  # noqa: E402
from alphatriangle_tpu.serving import PolicyService as JaxService  # noqa: E402
from alphatriangle_tpu_torch import rng  # noqa: E402
from alphatriangle_tpu_torch.env import TriangleEnv  # noqa: E402
from alphatriangle_tpu_torch.features import FeatureExtractor  # noqa: E402
from alphatriangle_tpu_torch.mcts import GumbelMCTS  # noqa: E402
from alphatriangle_tpu_torch.nn.model import value_support  # noqa: E402
from alphatriangle_tpu_torch.nn.network import LiveWeights  # noqa: E402
from alphatriangle_tpu_torch.serving import PolicyService  # noqa: E402
from test_torch_self_play import _assert_tree, _engines  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import default_device_stats  # noqa: E402
from torch_parity import (  # noqa: E402
    CPU,
    JaxExactStub,
    TorchExactStub,
    assert_stat_packs,
    inject_jax_noise,
    small_model_config,
    torch_cfg,
    torch_key,
)

POLICY_ATOL = 1e-6
MOVES = 8
TRAIN = dict(N_STEP_RETURNS=2, MAX_EPISODE_MOVES=30, TEMPERATURE_ANNEAL_MOVES=4)


@pytest.fixture(autouse=True)
def _jax_noise(monkeypatch):
    inject_jax_noise(monkeypatch)


def _mcts_kw(root: str, record: bool) -> dict:
    return dict(
        max_simulations=8, max_depth=4, mcts_batch_size=4, fast_simulations=4,
        full_search_prob=0.5, pcr_record_fast_rows=record, root_selection=root,
    )


CASES = [(root, record) for root in ("puct", "gumbel") for record in (False, True)]


@pytest.fixture(scope="module")
def pcr_engines(tiny_env_config) -> dict:
    """(root, record) -> (JAX engine, port engine); the JAX chunk
    programs compile together in threads before the first case."""
    default_device_stats()  # a search reads the stat-pack flag when built
    compiled: dict = {}
    pairs = {
        case: _engines(tiny_env_config, TRAIN, 5, _mcts_kw(*case), compiled, stats=True)
        for case in CASES
    }
    with ThreadPoolExecutor(len(pairs)) as pool:
        assert all(pool.map(lambda case: pairs[case][0].warm_chunk(MOVES), pairs))
    pairs["compiled"] = compiled
    return pairs


class TestPCRChunk:
    @pytest.mark.parametrize("root,record", CASES)
    def test_chunk_matches_jax(self, pcr_engines, root, record):
        jeng, teng = pcr_engines[(root, record)]
        assert teng.mcts_fast.config.max_simulations == 4
        assert teng.mcts_fast.config.dirichlet_epsilon == 0.0
        assert getattr(teng.mcts_fast, "exploit", None) is (True if root == "gumbel" else None)
        jcarry, jout = jeng._chunk_fn(MOVES)({}, jeng._carry, jnp.int32(11))
        tcarry, tout = teng._chunk(MOVES, teng._carry, LiveWeights(11, teng.net.model))
        jout = jax.device_get(jout)
        jout["trace"] = {k: jout["trace"][k] for k in tout["trace"]}
        # Full and fast moves' stat-packs, stacked over the chunk: the
        # histogram counts each move's own simulations.
        packs = tout.pop("device_stats")
        assert_stat_packs(packs, jout.pop("device_stats"), f"{root} record={record}")
        is_full = tout["trace"]["is_full"].numpy()
        sims_per_move = packs[:, :16].sum(dim=1).numpy()
        np.testing.assert_array_equal(sims_per_move, np.where(is_full, 8, 4) * 5)
        assert 0 < is_full.sum() < MOVES  # both kinds of move in the chunk
        np.testing.assert_array_equal(is_full, jout["trace"]["is_full"])
        np.testing.assert_array_equal(tout["trace"]["sims"].numpy(), np.where(is_full, 8, 4))
        # The policy weights: 1 on full moves, 0 on fast ones.
        assert set(np.unique(tout["flush"]["pw"].numpy())) <= {0.0, 1.0}
        if root == "gumbel":
            for block in ("mat", "flush"):
                np.testing.assert_allclose(
                    tout[block]["policy"].numpy(), jout[block]["policy"], atol=POLICY_ATOL
                )
                tout[block]["policy"] = jout[block]["policy"]
        _assert_tree(tout, jout)
        mask = tout["mat"]["mask"].numpy()
        if not record:
            # No fast move's row matures into the ring.
            assert (tout["mat"]["pw"].numpy()[mask] == 1.0).all()
            assert (tout["flush"]["pw"].numpy()[tout["flush"]["mask"].numpy()] == 1.0).all()
        np.testing.assert_array_equal(tcarry.pend_pweight.numpy(), np.asarray(jcarry.pend_pweight))
        np.testing.assert_array_equal(tcarry.rng.numpy(), np.asarray(jcarry.rng).astype(np.int64))

    def test_harvest_counts_the_simulations_run(self, tiny_env_config, pcr_engines):
        # Fresh engines (the chunk test donated the first JAX carry) that
        # share the compiled chunk program.
        jeng, teng = _engines(tiny_env_config, TRAIN, 5, _mcts_kw("puct", False), pcr_engines["compiled"])
        want, got = jeng.play_moves(MOVES), teng.play_moves(MOVES)
        assert got.total_simulations == want.total_simulations
        assert got.total_simulations == int(teng.last_trace["sims"].sum()) * 5
        assert got.num_experiences == want.num_experiences
        np.testing.assert_array_equal(got.policy_weight, want.policy_weight)
        np.testing.assert_array_equal(teng.last_trace["is_full"], jeng.last_trace["is_full"])


def test_bernoulli_matches_jax():
    for seed in range(64):
        for p in (0.25, 0.5, 0.9):
            key = jax.random.PRNGKey(seed)
            assert rng.bernoulli(torch_key(key), p) == bool(jax.random.bernoulli(key, p))
    key = jax.random.PRNGKey(3)
    np.testing.assert_array_equal(
        rng.bernoulli(torch_key(key), 0.3, (6, 5)).numpy(),
        np.asarray(jax.random.bernoulli(key, 0.3, (6, 5))),
    )


SLOTS = 4


class TestGumbelServing:
    def test_dispatches_match_jax(self, tiny_env_config):
        """Four dispatches of three sessions through a Gumbel exploit
        search (as `cli serve --gumbel`): the served actions are the
        search's selections, equal on both sides."""
        cfg = AlphaTriangleMCTSConfig(
            max_simulations=8, max_depth=4, mcts_batch_size=4, root_selection="gumbel"
        )
        model_cfg = small_model_config(tiny_env_config)
        adim, atoms = tiny_env_config.action_dim, model_cfg.NUM_VALUE_ATOMS
        support = value_support(torch_cfg(model_cfg))
        jenv = JaxEnv(tiny_env_config)
        jfe = get_feature_extractor(jenv, model_cfg)
        tenv = TriangleEnv(torch_cfg(tiny_env_config), device=CPU)
        tfe = FeatureExtractor(tenv, torch_cfg(model_cfg))
        jm = JaxGumbel(
            jenv, jfe, JaxExactStub(adim, atoms), cfg, jnp.asarray(support.numpy()), exploit=True
        )
        tm = GumbelMCTS(tenv, tfe, TorchExactStub(adim, atoms), torch_cfg(cfg), support, exploit=True)
        jnet = SimpleNamespace(model=jm.model, support=jm.support, weights_version=0, variables={})
        tnet = SimpleNamespace(model=tm.model, support=support, weights_version=0)
        jsvc = JaxService(jenv, jfe, jnet, jm, slots=SLOTS, rng_seed=5, use_gumbel=True)
        tsvc = PolicyService(tenv, tfe, tnet, tm, slots=SLOTS, rng_seed=5)
        jouts = []

        def recording(variables, states, key):
            out = jm.search(variables, states, key)
            jouts.append(out)
            return out

        jsvc._programs[SLOTS] = recording
        keys = jax.random.split(jax.random.PRNGKey(21), 3)
        jsess, tsess = jsvc.open_sessions(keys), tsvc.open_sessions(torch_key(keys))
        for _ in range(4):
            for js, ts in zip(jsess, tsess, strict=True):
                if not js.done:
                    jsvc.request_move(js.sid)
                    tsvc.request_move(ts.sid)
            jres, tres = jsvc.dispatch(), tsvc.dispatch()
            jout, tout = jouts[-1], tsvc.last_output
            np.testing.assert_array_equal(
                tout.selected_action.numpy(), np.asarray(jout.selected_action)
            )
            np.testing.assert_array_equal(tout.visit_counts.numpy(), np.asarray(jout.visit_counts))
            assert len(tres) == len(jres) > 0
            for j, t in zip(jres, tres, strict=True):
                assert (t["slot"], t["action"], t["reward"], t["done"], t["score"]) == (
                    j["slot"], j["action"], j["reward"], j["done"], j["score"]
                )
            served = [t["slot"] for t in tres]
            picked = np.maximum(tout.selected_action.numpy(), 0)[served]
            assert [t["action"] for t in tres] == picked.tolist()
