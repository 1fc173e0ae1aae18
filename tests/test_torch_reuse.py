"""Parity of the PyTorch port's subtree reuse with the JAX package: the
promotion op (`ops/subtree_reuse.py`), the carried search
(`BatchedMCTS._search_carried` -> `promote`), a self-play chunk with
reuse, serving with reuse, and the megastep loop with reuse on the CPU.

The port draws its Gumbel and gamma noise through two functions of its
`rng`; these tests route both through `jax.random` for the same key. A
stub net whose outputs are exact stands in for the net on both sides.
Exact: the promotion's every output (in both JAX lowerings, the Pallas
one in interpret mode), visit counts, inherited visits, carried planes,
carry validity and bases, served actions and the harvests' rows. Root
values, noisy root priors and n-step returns take float sums in another
order: within 1e-6 (searches) and 1e-5 (chunk returns), as in
`test_torch_search.py` and `test_torch_self_play.py`. The scalar
features (`other`) agree within one ulp, as in `test_torch_self_play.py`.

The compiled JAX references are shared through module-scoped fixtures.
"""

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
from alphatriangle_tpu.mcts import BatchedMCTS as JaxMCTS  # noqa: E402
from alphatriangle_tpu.mcts.helpers import select_root_actions as jax_root_actions  # noqa: E402
from alphatriangle_tpu.ops.subtree_reuse import subtree_promote as jax_promote  # noqa: E402
from alphatriangle_tpu.rl.self_play import SelfPlayEngine as JaxEngine  # noqa: E402
from alphatriangle_tpu.serving import PolicyService as JaxService  # noqa: E402
from alphatriangle_tpu_torch.env import TriangleEnv  # noqa: E402
from alphatriangle_tpu_torch.features import FeatureExtractor  # noqa: E402
from alphatriangle_tpu_torch.mcts import BatchedMCTS, root_actions  # noqa: E402
from alphatriangle_tpu_torch.mcts.search import CarriedTree  # noqa: E402
from alphatriangle_tpu_torch.nn.model import value_support  # noqa: E402
from alphatriangle_tpu_torch.ops import KERNELS, subtree_promote  # noqa: E402
from alphatriangle_tpu_torch.rl import SelfPlayEngine  # noqa: E402
from alphatriangle_tpu_torch.serving import PolicyService  # noqa: E402
from alphatriangle_tpu_torch.training import TrainingLoop, setup_training_components  # noqa: E402
from test_torch_megastep import make_cfg  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import default_device_stats  # noqa: E402
from torch_parity import (  # noqa: E402
    CPU,
    JaxExactStub,
    TorchExactStub,
    inject_jax_noise,
    run_root,
    small_model_config,
    stub_net,
    to_torch_state,
    torch_cfg,
    torch_key,
)

SUM_ATOL = 1e-6  # searches: exact net outputs, float sums in another order
RET_ATOL = 1e-5  # chunk n-step returns and root values
ULP_RTOL = 2.5e-7  # one float32 ulp: XLA's rewrite of a feature's divisions
REUSE = dict(max_simulations=8, max_depth=4, mcts_batch_size=4, tree_reuse=True)
PLANES = ("e_visits", "e_value", "e_reward", "children", "prior", "valid", "terminal")


@pytest.fixture(autouse=True)
def _jax_noise(monkeypatch):
    inject_jax_noise(monkeypatch)


def _numpy(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_equal(got, want, msg=""):
    got, want = _numpy(got), _numpy(want)
    assert got.shape == want.shape, msg
    np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=msg)


# --- the promotion op ------------------------------------------------------


def _forest(seed: int, batch=6, nodes=20, actions=5):
    """Edge planes around random forests built as a search builds them:
    child ids increase away from the root, each node has at most one
    parent edge, lanes hold different node counts. Lane 1's chosen
    action is unexpanded (an invalid promotion); lane 2 is one long
    chain (deeper than the BFS rounds)."""
    pick = np.random.default_rng(seed)
    ch = np.full((batch, nodes, actions), -1.0, np.float32)
    for lane in range(batch):
        if lane == 2:
            for j in range(1, nodes):
                ch[lane, j - 1, pick.integers(0, actions)] = j
            continue
        for j in range(1, nodes - lane):
            parent, act = pick.integers(0, j), pick.integers(0, actions)
            if ch[lane, parent, act] < 0:
                ch[lane, parent, act] = j
    acts = np.zeros(batch, np.int32)
    for lane in range(batch):
        expanded = np.flatnonzero(ch[lane, 0] >= 0)
        acts[lane] = expanded[0] if lane != 1 else np.flatnonzero(ch[lane, 0] < 0)[0]
    planes = [
        pick.integers(0, 9, ch.shape).astype(np.float32),
        pick.standard_normal(ch.shape).astype(np.float32),
        pick.standard_normal(ch.shape).astype(np.float32),
        ch,
        pick.random(ch.shape).astype(np.float32),
        (pick.random(ch.shape) < 0.7).astype(np.float32),
    ]
    terminal = pick.random((batch, nodes)) < 0.3
    return planes, terminal, acts


class TestPromote:
    @pytest.mark.parametrize("mode", ["xla", "pallas"])
    @pytest.mark.parametrize("max_retained", [8, 3])
    def test_matches_jax(self, mode, max_retained):
        planes, terminal, acts = _forest(seed=max_retained)
        want = jax_promote(
            *[jnp.asarray(p) for p in planes], jnp.asarray(terminal), jnp.asarray(acts),
            max_retained=max_retained, bfs_rounds=4, mode=mode,
        )
        before = {k: v.launches for k, v in KERNELS.items()}
        got = subtree_promote(
            *[torch.from_numpy(p) for p in planes], torch.from_numpy(terminal),
            torch.from_numpy(acts), max_retained=max_retained, bfs_rounds=4, mode=mode,
        )
        assert {k: v.launches for k, v in KERNELS.items()} == before  # CPU: the plain version
        assert len(got) == len(want) == 10
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            _assert_equal(g, w, f"output {i}")
        promo_valid, retained = _numpy(got[8]), _numpy(got[9])
        assert not promo_valid[1] and retained[1] == 0
        assert (retained[promo_valid] == max_retained).any()  # truncation ran

    def test_unknown_mode_raises(self):
        planes, terminal, acts = _forest(seed=0)
        with pytest.raises(ValueError, match="unknown subtree_promote mode"):
            subtree_promote(
                *[torch.from_numpy(p) for p in planes], torch.from_numpy(terminal),
                torch.from_numpy(acts), max_retained=4, bfs_rounds=4, mode="cuda",
            )


# --- the carried search and serving ---------------------------------------

SLOTS = 4


@pytest.fixture(scope="module")
def reuse_world(tiny_env_config):
    """The JAX search and its port over the exact stub with reuse on, a
    JAX and a port PolicyService around them, the recorded JAX serve
    programs' outputs, and the JAX env. The service's jitted program
    (carried search, root argmax, promotion) is also the carried-search
    reference, so it compiles once."""
    default_device_stats()  # a search reads the stat-pack flag when built
    mcts_cfg = AlphaTriangleMCTSConfig(**REUSE)
    model_cfg = small_model_config(tiny_env_config)
    jenv = JaxEnv(tiny_env_config)
    tenv = TriangleEnv(torch_cfg(tiny_env_config), device=CPU)
    atoms, adim = model_cfg.NUM_VALUE_ATOMS, tiny_env_config.action_dim
    support = value_support(torch_cfg(model_cfg))
    jm = JaxMCTS(
        jenv, get_feature_extractor(jenv, model_cfg), JaxExactStub(adim, atoms), mcts_cfg,
        jnp.asarray(support.numpy()),
    )
    tm = BatchedMCTS(
        tenv, FeatureExtractor(tenv, torch_cfg(model_cfg)), TorchExactStub(adim, atoms),
        torch_cfg(mcts_cfg), support,
    )
    # The stubs ignore the weights: the services need a net only to hold them.
    jnet = SimpleNamespace(variables={}, weights_version=0, set_weights=lambda v: None)
    tnet = SimpleNamespace(set_weights=lambda sd: None)
    jsvc = JaxService(jenv, jm.extractor, jnet, jm, slots=SLOTS, rng_seed=5)
    tsvc = PolicyService(tenv, tm.extractor, tnet, tm, slots=SLOTS, rng_seed=5)
    jouts = []

    def recording(*args):
        res = jsvc._search_fn(*args)
        jouts.append(res)
        return res

    jsvc._programs[SLOTS] = recording
    return SimpleNamespace(jm=jm, tm=tm, jenv=jenv, jsvc=jsvc, tsvc=tsvc, jouts=jouts)


def _assert_carry(tc, jc, msg):
    _assert_equal(tc.valid, jc.valid, f"{msg} valid")
    _assert_equal(tc.base, jc.base, f"{msg} base")
    for name in PLANES:
        _assert_equal(getattr(tc.tree, name), getattr(jc.tree, name), f"{msg} {name}")
    want_states = to_torch_state(jc.tree.node_state)
    for name in want_states.__dataclass_fields__:
        got = getattr(tc.tree.node_state, name)
        _assert_equal(got, getattr(want_states, name), f"{msg} {name}")


class TestCarriedSearch:
    def test_three_moves_match_jax(self, reuse_world):
        w = reuse_world
        jm, tm, jenv = w.jm, w.tm, w.jenv
        assert tm.num_nodes == jm.num_nodes == 2 * REUSE["max_simulations"] + 1
        states = jenv.reset_batch(jax.random.split(jax.random.PRNGKey(3), SLOTS))
        done = np.asarray(states.done).copy()
        done[-1] = True  # a finished game: a terminal root
        states = states.replace(done=jnp.asarray(done))
        jc, tc = jm.zero_carried(states), tm.zero_carried(to_torch_state(states))
        ok = np.ones(SLOTS, bool)
        reused_total = 0.0
        for move in range(3):
            if move == 2:  # a lane whose carry the caller cleared
                ok[1] = False
            key = jax.random.PRNGKey(40 + move)
            jout, jc, jreused = w.jsvc._search_fn({}, states, key, jc, jnp.asarray(ok))
            tc = CarriedTree(tree=tc.tree, valid=tc.valid & torch.from_numpy(ok), base=tc.base)
            tout, ttree, treused = tm._search_carried(to_torch_state(states), torch_key(key), tc)
            _assert_equal(tout.visit_counts, jout.visit_counts, f"move {move} visits")
            _assert_equal(tout.wasted_slots, jout.wasted_slots, f"move {move} wasted")
            _assert_equal(treused, jreused, f"move {move} reused")
            for name in ("root_value", "root_prior"):
                np.testing.assert_allclose(
                    _numpy(getattr(tout, name)), np.asarray(getattr(jout, name)), rtol=0,
                    atol=SUM_ATOL, err_msg=f"move {move} {name}",
                )
            actions = jax_root_actions(jout)
            tact = root_actions(tout)
            _assert_equal(tact, actions, f"move {move} actions")
            tc = tm.promote(ttree, tact)
            _assert_carry(tc, jc, f"move {move}")
            reused_total += float(treused.sum())
            states, _, _ = jenv.step_batch(states, jnp.asarray(actions, jnp.int32))
        assert reused_total > 0 and float(treused[1]) == 0.0
        assert bool(tc.valid.any())

    def test_invalid_carry_is_the_fresh_search(self, reuse_world):
        tm, jenv = reuse_world.tm, reuse_world.jenv
        states = to_torch_state(jenv.reset_batch(jax.random.split(jax.random.PRNGKey(8), 3)))
        key = torch_key(jax.random.PRNGKey(9))
        fresh = tm.search(states, key)
        carried, _, reused = tm._search_carried(states, key, tm.zero_carried(states))
        _assert_equal(carried.visit_counts, fresh.visit_counts)
        _assert_equal(carried.root_value, fresh.root_value)
        assert float(reused.abs().sum()) == 0.0


# --- self-play with reuse -----------------------------------------------------


@pytest.fixture(scope="module")
def reuse_engines(tiny_env_config):
    """(JAX engine, port engine) with reuse on, over the exact stub."""
    default_device_stats()  # a search reads the stat-pack flag when built
    model_cfg = small_model_config(tiny_env_config)
    mcts_cfg = AlphaTriangleMCTSConfig(**REUSE)
    jcfg = JaxTrainConfig(
        AUTO_RESUME_LATEST=False, RUN_NAME="reuse", N_STEP_RETURNS=2, MAX_EPISODE_MOVES=30,
        TEMPERATURE_ANNEAL_MOVES=4,
    )
    adim, atoms = tiny_env_config.action_dim, model_cfg.NUM_VALUE_ATOMS
    support = value_support(torch_cfg(model_cfg))
    jenv = JaxEnv(tiny_env_config)
    jnet = SimpleNamespace(
        model=JaxExactStub(adim, atoms), support=jnp.asarray(support.numpy()),
        weights_version=3, variables={},
    )
    jeng = JaxEngine(
        jenv, get_feature_extractor(jenv, model_cfg), jnet, mcts_cfg, jcfg, batch_size=5, seed=9,
    )
    tenv = TriangleEnv(torch_cfg(tiny_env_config), device=CPU)
    tnet = stub_net(TorchExactStub(adim, atoms), support)
    teng = SelfPlayEngine(
        tenv, FeatureExtractor(tenv, torch_cfg(model_cfg)), tnet, torch_cfg(mcts_cfg),
        torch_cfg(jcfg), batch_size=5, seed=9,
    )
    return jeng, teng


class TestSelfPlayReuse:
    def test_harvest_and_trace_match_jax(self, reuse_engines):
        jeng, teng = reuse_engines
        reused = 0
        for _ in range(2):
            want, got = jeng.play_moves(4), teng.play_moves(4)
            assert got.num_experiences == want.num_experiences > 0
            for name in ("grid", "policy_target", "policy_weight"):
                _assert_equal(getattr(got, name), getattr(want, name), name)
            np.testing.assert_allclose(
                got.other_features, want.other_features, rtol=ULP_RTOL, atol=0
            )
            np.testing.assert_allclose(got.value_target, want.value_target, atol=RET_ATOL)
            for name in (
                "episode_scores", "episode_lengths", "num_episodes", "num_truncated",
                "total_simulations", "total_reused_visits",
            ):
                assert getattr(got, name) == getattr(want, name), name
            _assert_equal(teng.last_trace["reused"], jeng.last_trace["reused"], "trace reused")
            for name in ("reward", "ending", "wasted_slots"):
                _assert_equal(teng.last_trace[name], jeng.last_trace[name], name)
            np.testing.assert_allclose(
                teng.last_trace["root_value"], jeng.last_trace["root_value"], atol=RET_ATOL
            )
            reused += got.total_reused_visits
        assert reused > 0
        assert bool(jeng.last_trace["ending"].any())  # some lanes restarted fresh
        # The carries agree: validity (ended games cleared) and bases.
        jt, tt = jeng._carry.tree, teng._carry.tree
        _assert_equal(tt.valid, jt.valid, "carry valid")
        _assert_equal(tt.base, jt.base, "carry base")
        _assert_equal(tt.tree.e_visits, jt.tree.e_visits, "carry e_visits")


# --- serving with reuse -------------------------------------------------------


class TestServingReuse:
    def test_dispatches_with_churn_and_reload_match_jax(self, reuse_world):
        jsvc, tsvc, jouts = reuse_world.jsvc, reuse_world.tsvc, reuse_world.jouts
        keys = jax.random.split(jax.random.PRNGKey(21), 3)
        jsess, tsess = jsvc.open_sessions(keys), tsvc.open_sessions(torch_key(keys))
        pairs = list(zip(jsess, tsess, strict=True))
        for step in range(6):
            if step == 2:  # churn: a session leaves, another takes its slot
                js, ts = pairs.pop(0)
                assert tsvc.close_session(ts.sid) == jsvc.close_session(js.sid)
                key = jax.random.PRNGKey(77)
                pairs.append((jsvc.open_session(key), tsvc.open_session(torch_key(key))))
                assert pairs[-1][0].slot == pairs[-1][1].slot
                assert not tsvc._carry_ok[pairs[-1][1].slot]
            if step == 4:  # a reload clears every lane's carry
                assert tsvc.reload_weights() == jsvc.reload_weights()
                assert not tsvc._carry_ok.any()
            for js, ts in pairs:
                if not js.done:
                    jsvc.request_move(js.sid)
                    tsvc.request_move(ts.sid)
            jres, tres = jsvc.dispatch(), tsvc.dispatch()
            assert len(tres) == len(jres) > 0
            for j, t in zip(jres, tres, strict=True):
                assert (t["slot"], t["move"], t["action"], t["done"]) == (
                    j["slot"], j["move"], j["action"], j["done"]
                )
                assert t["reward"] == j["reward"] and t["score"] == j["score"]
            jout, jcarried, jreused = jouts[-1]
            _assert_equal(tsvc.last_output.visit_counts, jout.visit_counts, f"dispatch {step}")
            _assert_equal(tsvc.last_reused, jreused, f"dispatch {step} reused")
            _assert_equal(tsvc._carry_ok, jsvc._carry_ok, f"dispatch {step} carry_ok")
            _assert_equal(tsvc._carried.base, jsvc._carried.base, f"dispatch {step} base")
            assert tsvc.reused_visits_total == jsvc.reused_visits_total
            if step == 4:
                assert float(tsvc.last_reused.sum()) == 0.0  # searched afresh after the reload
        assert tsvc.reused_visits_total > 0
        assert tsvc.serve_stats()["serve_reused_visits_total"] == tsvc.reused_visits_total


# --- the megastep loop with reuse ---------------------------------------------


class TestTrainingReuse:
    def test_megastep_loop_reuses_visits(
        self, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
    ):
        mcts_cfg = tiny_mcts_config.model_copy(update={"tree_reuse": True})
        c = setup_training_components(
            torch_cfg(make_cfg(MAX_TRAINING_STEPS=4)), torch_cfg(tiny_env_config),
            torch_cfg(tiny_model_config), torch_cfg(mcts_cfg),
            persistence_config=run_root(tmp_path), device=CPU,
        )
        assert c.self_play.mcts.num_nodes == 2 * mcts_cfg.max_simulations + 1
        loop = TrainingLoop(c)
        assert loop.run().value == "completed"
        assert loop.megastep_iterations == 2 and loop.global_step == 4
        assert all(np.isfinite(m["total_loss"]) for m in loop.metrics)
        assert loop.total_reused_visits > 0
        assert loop.report()["reused_visits"] == loop.total_reused_visits
        assert c.self_play._carry.tree is not None
