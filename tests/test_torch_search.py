"""Parity of the PyTorch port's search (`mcts/`) with the JAX package.

The port draws its Gumbel and gamma noise through two functions of its
`rng`; these tests route both through `jax.random` for the same key, so
the two searches see the same noise.

A stub net whose outputs are exact (zero policy logits, value logits on
one atom) stands in for the net on both sides. Visit counts and wasted
slots must match exactly; root values and noisy root priors, which take
float sums in another order, within 1e-6. `test_torch_serving.py` holds
the slice as a whole, with the real net too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from alphatriangle_tpu.config import AlphaTriangleMCTSConfig, EnvConfig  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.mcts import BatchedMCTS as JaxMCTS  # noqa: E402
from alphatriangle_tpu.mcts.helpers import policy_target_from_visits as jax_target  # noqa: E402
from alphatriangle_tpu.mcts.helpers import select_root_actions as jax_select  # noqa: E402
from alphatriangle_tpu_torch import rng  # noqa: E402
from alphatriangle_tpu_torch.env import TriangleEnv  # noqa: E402
from alphatriangle_tpu_torch.features import FeatureExtractor  # noqa: E402
from alphatriangle_tpu_torch.mcts import (  # noqa: E402
    BatchedMCTS,
    policy_target_from_visits,
    select_root_actions,
)
from alphatriangle_tpu_torch.nn.model import value_support  # noqa: E402
from alphatriangle_tpu_torch.ops import KERNELS  # noqa: E402
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

SUM_ATOL = 1e-6  # exact net outputs; only the order of float sums differs


@pytest.fixture(autouse=True)
def _jax_noise(monkeypatch):
    inject_jax_noise(monkeypatch)


def _stub_world(jenv_cfg, mcts_cfg):
    """(JAX search, port search, JAX env, port env) over the exact stub."""
    model_cfg = small_model_config(jenv_cfg)
    jenv = JaxEnv(jenv_cfg)
    tenv = TriangleEnv(torch_cfg(jenv_cfg), device=CPU)
    atoms, adim = model_cfg.NUM_VALUE_ATOMS, jenv_cfg.action_dim
    tmodel_cfg = torch_cfg(model_cfg)
    support = value_support(tmodel_cfg)  # one support on both sides
    jm = JaxMCTS(
        jenv, get_feature_extractor(jenv, model_cfg), JaxExactStub(adim, atoms),
        mcts_cfg, jax.numpy.asarray(support.numpy()),
    )
    tm = BatchedMCTS(
        tenv, FeatureExtractor(tenv, tmodel_cfg), TorchExactStub(adim, atoms),
        torch_cfg(mcts_cfg), support,
    )
    return jm, tm, jenv, tenv


def _roots(jenv, batch: int, seed: int, moves: int = 0):
    """Batched JAX roots, a few random legal moves into their games,
    with one finished game (terminal root)."""
    states = jenv.reset_batch(jax.random.split(jax.random.PRNGKey(seed), batch))
    pick = np.random.default_rng(seed)
    for _ in range(moves):
        mask = np.asarray(jenv.valid_mask_batch(states))
        acts = np.array([pick.choice(np.flatnonzero(m)) if m.any() else 0 for m in mask])
        states, _, _ = jenv.step_batch(states, jax.numpy.asarray(acts, jax.numpy.int32))
    done = np.asarray(states.done).copy()
    done[-1] = True
    return states.replace(done=jax.numpy.asarray(done))


class TestExactSearch:
    @pytest.mark.parametrize(
        "board,sims,depth,wave,epsilon",
        [
            ("tiny", 8, 5, 4, 0.25),
            ("tiny", 12, 4, 6, 0.0),
            ("tiny", 16, 6, 1, 0.25),
            ("flagship", 16, 8, 8, 0.25),
        ],
    )
    def test_visit_counts_match_jax(
        self, tiny_env_config, board, sims, depth, wave, epsilon
    ):
        jenv_cfg = tiny_env_config if board == "tiny" else EnvConfig()
        mcts_cfg = AlphaTriangleMCTSConfig(
            max_simulations=sims, max_depth=depth, mcts_batch_size=wave,
            dirichlet_epsilon=epsilon,
        )
        jm, tm, jenv, _ = _stub_world(jenv_cfg, mcts_cfg)
        roots = _roots(jenv, 5, seed=sims, moves=3)
        key = jax.random.PRNGKey(11)
        jout = jm.search({}, roots, key)
        tout = tm.search(to_torch_state(roots), torch_key(key))
        np.testing.assert_array_equal(tout.visit_counts.numpy(), np.asarray(jout.visit_counts))
        np.testing.assert_allclose(
            tout.root_prior.numpy(), np.asarray(jout.root_prior), rtol=0, atol=SUM_ATOL
        )
        np.testing.assert_array_equal(tout.wasted_slots.numpy(), np.asarray(jout.wasted_slots))
        np.testing.assert_allclose(
            tout.root_value.numpy(), np.asarray(jout.root_value), rtol=0, atol=SUM_ATOL
        )
        assert tout.total_simulations == int(jout.total_simulations)
        assert tout.stats is None

    def test_cpu_search_never_launches_a_kernel(self, tiny_env_config, tiny_mcts_config):
        _, tm, jenv, _ = _stub_world(tiny_env_config, tiny_mcts_config)
        before = {k: v.launches for k, v in KERNELS.items()}
        tm.search(to_torch_state(_roots(jenv, 3, seed=2)), rng.PRNGKey(1))
        assert {k: v.launches for k, v in KERNELS.items()} == before


class TestHelpers:
    def test_root_actions_and_targets_match_jax(self):
        pick = np.random.default_rng(3)
        counts = pick.integers(0, 4, (7, 12)).astype(np.float32)
        counts[2] = 0.0  # no visits: action 0, uniform fallback
        counts[4, [1, 5]] = 9.0  # tie: the first maximum
        valid = pick.random((7, 12)) < 0.6

        class Out:
            visit_counts = counts

        class TOut:
            visit_counts = torch.from_numpy(counts)

        np.testing.assert_array_equal(select_root_actions(TOut), jax_select(Out))
        for mask in (None, valid):
            got = policy_target_from_visits(
                torch.from_numpy(counts), None if mask is None else torch.from_numpy(mask)
            )
            want = jax_target(counts, None if mask is None else jax.numpy.asarray(mask))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
