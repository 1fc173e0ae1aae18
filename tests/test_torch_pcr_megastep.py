"""Parity of one fused megastep under the flagship recipe (Gumbel root
search with playout-cap randomization, preset 3's search) with the JAX
`MegastepRunner`, on the JAX megastep tests' tiny world.

The same procedure and tolerances as `test_torch_megastep.py`, with a
search config of Gumbel roots, full searches of 8 simulations and fast
ones of 2 at p = 0.5: the warm-up ingests, the megastep's rows, ring
slots and sampled slots are exact, as is its trace's `is_full`
sequence; the improved-policy targets within 1e-5 (root values of two
float32 forwards that differ by rounding); losses and TD errors within
1e-4 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu.config import AlphaTriangleMCTSConfig  # noqa: E402
from alphatriangle_tpu_torch.training import setup_training_components  # noqa: E402
from test_torch_megastep import LOSS_RTOL, SUM_ATOL, _jax_side, _warm_up, make_cfg  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import CPU, converted_state_dict, inject_jax_noise, run_root, torch_cfg  # noqa: E402


@pytest.fixture(autouse=True)
def _jax_noise(monkeypatch):
    inject_jax_noise(monkeypatch)


def test_gumbel_pcr_megastep_matches_jax(tmp_path, tiny_env_config, tiny_model_config):
    mcts = AlphaTriangleMCTSConfig(
        max_simulations=8, max_depth=4, mcts_batch_size=4, root_selection="gumbel",
        fast_simulations=2, full_search_prob=0.5,
    )
    jtc = make_cfg(ROLLOUT_CHUNK_MOVES=4)
    jeng, jtrainer, jring, jrunner, jnet, jouts = _jax_side(
        tiny_env_config, tiny_model_config, mcts, jtc
    )
    c = setup_training_components(
        torch_cfg(jtc), torch_cfg(tiny_env_config), torch_cfg(tiny_model_config),
        torch_cfg(mcts), persistence_config=run_root(tmp_path), device=CPU,
    )
    c.net.model.load_state_dict(converted_state_dict(jnet))
    assert c.self_play.use_gumbel and c.self_play.mcts_fast.exploit

    assert _warm_up(c.self_play, c.buffer, jtc) == _warm_up(jeng, jring, jtc)
    jrunner.sync_priorities_from_host()
    c.megastep.sync_priorities_from_host()
    k = jtc.FUSED_LEARNER_STEPS
    jres, jcount = jrunner.run_megastep(jtc.ROLLOUT_CHUNK_MOVES, k)
    res, count = c.megastep.run_megastep(jtc.ROLLOUT_CHUNK_MOVES, k)

    assert count == jcount
    is_full = c.self_play.last_trace["is_full"]
    np.testing.assert_array_equal(is_full, np.asarray(jouts[0]["trace"]["is_full"]))
    np.testing.assert_array_equal(c.self_play.last_trace["sims"], np.where(is_full, 8, 2))
    assert c.self_play.harvest().total_simulations == jeng.harvest().total_simulations
    assert (c.buffer._pos, len(c.buffer)) == (jring._pos, len(jring))
    np.testing.assert_array_equal(c.megastep.last_idx, np.asarray(jouts[0]["idx"]))
    cap = jtc.BUFFER_CAPACITY
    for name, col in jring.storage.items():
        got, want = c.buffer.storage[name][:cap].numpy(), np.asarray(col)[:cap]
        if name == "value_target":
            np.testing.assert_allclose(got, want, atol=SUM_ATOL)
        elif name == "other_features":
            np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
        elif name == "policy_target":
            # The completed-Q improved policy: a softmax in each framework
            # over root values of two float32 forwards (NET_ATOL of
            # test_torch_serving.py).
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    for (m, td), (jm, jtd) in zip(res, jres):
        for key in ("total_loss", "policy_loss", "value_loss", "entropy", "grad_norm"):
            np.testing.assert_allclose(m[key], jm[key], rtol=LOSS_RTOL, err_msg=key)
        np.testing.assert_allclose(td, jtd, rtol=LOSS_RTOL, atol=1e-6)
    assert c.trainer.global_step == jtrainer.global_step == k
