"""Parity of the PyTorch port's Gumbel root search (`mcts/gumbel.py`,
and the forced root actions of `BatchedMCTS._descend_wave`) with the
JAX package.

The port draws its Gumbel noise through `rng.gumbel`; these tests route
it through `jax.random` for the same key, so both searches see the same
root sample and the same descent noise. A stub net whose outputs are
exact (zero policy logits, value logits on one atom) stands in for the
net on both sides. Its uniform priors tie every root action under
`exploit=True`, which covers the tie rule of the candidate cut and of
the halving. Selected actions, visit counts, wasted slots and root
values must be equal; the improved policy, a softmax in each framework,
within 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alphatriangle_tpu.config import AlphaTriangleMCTSConfig, EnvConfig  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.mcts import BatchedMCTS as JaxMCTS  # noqa: E402
from alphatriangle_tpu.mcts.gumbel import GumbelMCTS as JaxGumbel  # noqa: E402
from alphatriangle_tpu.mcts.helpers import select_root_actions as jax_select  # noqa: E402
from alphatriangle_tpu_torch.env import TriangleEnv  # noqa: E402
from alphatriangle_tpu_torch.features import FeatureExtractor  # noqa: E402
from alphatriangle_tpu_torch.mcts import BatchedMCTS, GumbelMCTS, select_root_actions  # noqa: E402
from alphatriangle_tpu_torch.nn.model import value_support  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    CPU,
    JaxExactStub,
    TorchExactStub,
    inject_jax_noise,
    small_model_config,
    to_torch_state,
    torch_cfg,
    torch_key,
)

POLICY_ATOL = 1e-6  # the improved policy: each framework's own softmax


@pytest.fixture(autouse=True)
def _jax_noise(monkeypatch):
    inject_jax_noise(monkeypatch)


def _world(jenv_cfg, mcts_cfg, gumbel: bool = True, exploit: bool = False):
    """(JAX search, port search, JAX env) over the exact stub."""
    model_cfg = small_model_config(jenv_cfg)
    jenv = JaxEnv(jenv_cfg)
    tenv = TriangleEnv(torch_cfg(jenv_cfg), device=CPU)
    atoms, adim = model_cfg.NUM_VALUE_ATOMS, jenv_cfg.action_dim
    support = value_support(torch_cfg(model_cfg))
    jargs = (jenv, get_feature_extractor(jenv, model_cfg), JaxExactStub(adim, atoms), mcts_cfg,
             jnp.asarray(support.numpy()))
    targs = (tenv, FeatureExtractor(tenv, torch_cfg(model_cfg)), TorchExactStub(adim, atoms),
             torch_cfg(mcts_cfg), support)
    if gumbel:
        return JaxGumbel(*jargs, exploit=exploit), GumbelMCTS(*targs, exploit=exploit), jenv
    return JaxMCTS(*jargs), BatchedMCTS(*targs), jenv


def _roots(jenv, batch: int, seed: int, moves: int):
    """Batched JAX roots a few random legal moves into their games; the
    last one finished (a terminal root)."""
    states = jenv.reset_batch(jax.random.split(jax.random.PRNGKey(seed), batch))
    pick = np.random.default_rng(seed)
    for _ in range(moves):
        mask = np.asarray(jenv.valid_mask_batch(states))
        acts = np.array([pick.choice(np.flatnonzero(m)) if m.any() else 0 for m in mask])
        states, _, _ = jenv.step_batch(states, jnp.asarray(acts, jnp.int32))
    done = np.asarray(states.done).copy()
    done[-1] = True
    return states.replace(done=jnp.asarray(done))


# (board, sims, wave, gumbel_m, exploit, moves): one wave with m > W;
# several halving phases; m above the valid actions of a tiny board
# deep in its game; every action tied (exploit over uniform priors).
CASES = [
    ("tiny", 8, 8, 16, False, 0),
    ("tiny", 16, 4, 4, False, 3),
    ("tiny", 12, 4, 16, False, 5),
    ("tiny", 16, 8, 16, True, 2),
    ("tiny", 12, 3, 2, True, 4),
    ("flagship", 16, 8, 16, False, 2),
    ("flagship", 32, 8, 4, False, 1),
]


class TestGumbelSearch:
    @pytest.mark.parametrize("board,sims,wave,m,exploit,moves", CASES)
    def test_matches_jax(self, tiny_env_config, board, sims, wave, m, exploit, moves):
        jenv_cfg = tiny_env_config if board == "tiny" else EnvConfig()
        cfg = AlphaTriangleMCTSConfig(
            max_simulations=sims, max_depth=5, mcts_batch_size=wave, gumbel_m=m,
            root_selection="gumbel",
        )
        jm, tm, jenv = _world(jenv_cfg, cfg, exploit=exploit)
        assert tm.num_waves == sims // wave and tm.config.dirichlet_epsilon == 0.0
        roots = _roots(jenv, 6, seed=sims + moves, moves=moves)
        key = jax.random.PRNGKey(sims * 7 + m)
        jout = jax.device_get(jm.search({}, roots, key))
        tout = tm.search(to_torch_state(roots), torch_key(key))
        np.testing.assert_array_equal(tout.selected_action.numpy(), jout.selected_action)
        np.testing.assert_array_equal(tout.visit_counts.numpy(), jout.visit_counts)
        np.testing.assert_array_equal(tout.wasted_slots.numpy(), jout.wasted_slots)
        np.testing.assert_array_equal(tout.root_value.numpy(), jout.root_value)
        np.testing.assert_allclose(
            tout.improved_policy.numpy(), jout.improved_policy, rtol=0, atol=POLICY_ATOL
        )
        assert tout.total_simulations == int(jout.total_simulations)
        assert tout.selected_action[-1] == -1  # the terminal root
        np.testing.assert_array_equal(
            select_root_actions(tout, use_gumbel=True), np.asarray(jax_select(jout, use_gumbel=True))
        )
        if board == "tiny" and moves >= 4:
            # Fewer valid actions than m in some game: every one of them a candidate.
            valid = np.asarray(jenv.valid_mask_batch(roots))
            assert (valid.sum(-1) < m).any()

    def test_descend_wave_forced_roots_match_jax(self, tiny_env_config):
        cfg = AlphaTriangleMCTSConfig(max_simulations=16, max_depth=4, mcts_batch_size=4)
        jm, tm, jenv = _world(tiny_env_config, cfg, gumbel=False)
        roots = _roots(jenv, 5, seed=3, moves=2)
        troots = to_torch_state(roots)
        key = jax.random.PRNGKey(4)
        k_init, k_wave, k_desc = jax.random.split(key, 3)
        ttree = tm._init_tree(troots, torch_key(k_init))
        # One PUCT wave first, so forced members can find expanded edges.
        jtree = jax.jit(
            lambda r: jm._wave(
                {}, 5, (jm._init_tree({}, r, k_init), jnp.zeros(5, jnp.int32), jnp.int32(1)), k_wave
            )[0]
        )(roots)
        tm._wave(5, ttree, torch.zeros(5, dtype=torch.int32), 1, torch_key(k_wave))
        valid = np.asarray(jenv.valid_mask_batch(roots))
        pick = np.random.default_rng(5)
        forced = np.array(
            [[pick.choice(np.flatnonzero(v)) if v.any() and pick.random() < 0.7 else -1
              for _ in range(4)] for v in valid],
            dtype=np.int32,
        )
        want = jax.device_get(
            jax.jit(lambda t, f: jm._descend_wave(t, k_desc, 5, f))(jtree, jnp.asarray(forced))
        )
        got = tm._descend_wave(ttree, torch_key(k_desc), 5, torch.from_numpy(forced).long())
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
        first = got["rec_action"][:, :, 0].numpy()
        assert (first[forced >= 0] == forced[forced >= 0]).all()
