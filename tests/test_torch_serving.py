"""Parity of the PyTorch port's policy-serving slice (`serving/`, driven
through the search) with the JAX package, plus the port's own session,
queue and load-generator behaviour.

The port draws its Gumbel and gamma noise through two functions of its
`rng`; these tests route both through `jax.random` for the same key.

- Stub net (exact outputs): over several dispatches of identical
  sessions, served actions, rewards, scores and visit counts match
  exactly; root values and noisy root priors, which take float sums in
  another order, within 1e-6.
- Real net: the same small net on both sides, the port's weights
  converted from the Flax variables, in float32. Root priors and root
  values agree within 1e-5 over several dispatches: the two forwards
  differ by float rounding (`test_torch_net.py`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.mcts import BatchedMCTS as JaxMCTS  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.serving import PolicyService as JaxService  # noqa: E402
from alphatriangle_tpu_torch import rng  # noqa: E402
from alphatriangle_tpu_torch.env import TriangleEnv  # noqa: E402
from alphatriangle_tpu_torch.features import FeatureExtractor  # noqa: E402
from alphatriangle_tpu_torch.mcts import BatchedMCTS  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork  # noqa: E402
from alphatriangle_tpu_torch.serving import (  # noqa: E402
    PolicyService,
    SessionSlots,
    run_simulated_load,
)
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    CPU,
    JaxExactStub,
    TorchExactStub,
    converted_state_dict,
    inject_jax_noise,
    small_model_config,
    torch_cfg,
    torch_key,
)

SUM_ATOL = 1e-6  # exact net outputs; only the order of float sums differs
NET_ATOL = 1e-5  # float32 forwards that differ by rounding


@pytest.fixture(autouse=True)
def _jax_noise(monkeypatch):
    inject_jax_noise(monkeypatch)


SLOTS = 4


def _service_pair(jenv_cfg, mcts_cfg, net: str, **model_kw):
    """A JAX and a port PolicyService over the same net: the exact stub
    or the small real net with converted weights."""
    model_cfg = small_model_config(jenv_cfg, **model_kw)
    jenv = JaxEnv(jenv_cfg)
    jfe = get_feature_extractor(jenv, model_cfg)
    tenv = TriangleEnv(torch_cfg(jenv_cfg), device=CPU)
    tfe = FeatureExtractor(tenv, torch_cfg(model_cfg))
    jnet = JaxNetwork(model_cfg, jenv_cfg, seed=3)
    tnet = NeuralNetwork(
        torch_cfg(model_cfg), torch_cfg(jenv_cfg), state_dict=converted_state_dict(jnet),
        device=CPU,
    )
    if net == "stub":
        adim, atoms = jenv_cfg.action_dim, model_cfg.NUM_VALUE_ATOMS
        jmodel, tmodel = JaxExactStub(adim, atoms), TorchExactStub(adim, atoms)
        jsupport = jax.numpy.asarray(tnet.support.numpy())  # one support on both sides
    else:
        jmodel, tmodel, jsupport = jnet.model, tnet.model, jnet.support
    jm = JaxMCTS(jenv, jfe, jmodel, mcts_cfg, jsupport)
    tm = BatchedMCTS(tenv, tfe, tmodel, torch_cfg(mcts_cfg), tnet.support)
    jsvc = JaxService(jenv, jfe, jnet, jm, slots=SLOTS, rng_seed=5)
    tsvc = PolicyService(tenv, tfe, tnet, tm, slots=SLOTS, rng_seed=5)
    # Record the JAX search outputs: call the raw jitted search in place
    # of the service's cached program.
    jouts = []

    def recording(variables, states, key):
        out = jm.search(variables, states, key)
        jouts.append(out)
        return out

    jsvc._programs[SLOTS] = recording
    return jsvc, tsvc, jouts


def _open_same_sessions(jsvc, tsvc, n: int):
    keys = jax.random.split(jax.random.PRNGKey(21), n)
    jsess = jsvc.open_sessions(keys)
    tsess = tsvc.open_sessions(torch_key(keys))
    assert [s.slot for s in jsess] == [s.slot for s in tsess]
    return jsess, tsess


class TestServiceParity:
    @pytest.mark.parametrize("net", ["stub", "real"])
    def test_dispatches_match_jax(self, tiny_env_config, tiny_mcts_config, net):
        jsvc, tsvc, jouts = _service_pair(tiny_env_config, tiny_mcts_config, net)
        jsess, tsess = _open_same_sessions(jsvc, tsvc, 3)
        dispatches = 4
        for step in range(dispatches):
            for js, ts in zip(jsess, tsess, strict=True):
                if not js.done:
                    jsvc.request_move(js.sid)
                    tsvc.request_move(ts.sid)
            assert tsvc.queue_depth == jsvc.queue_depth
            jres, tres = jsvc.dispatch(), tsvc.dispatch()
            jout, tout = jouts[-1], tsvc.last_output
            np.testing.assert_allclose(
                tout.root_prior.numpy(), np.asarray(jout.root_prior), rtol=0, atol=NET_ATOL
            )
            atol = SUM_ATOL if net == "stub" else NET_ATOL
            np.testing.assert_allclose(
                tout.root_value.numpy(), np.asarray(jout.root_value), rtol=0, atol=atol
            )
            if net == "stub":
                np.testing.assert_array_equal(
                    tout.visit_counts.numpy(), np.asarray(jout.visit_counts)
                )
                for j, t in zip(jres, tres, strict=True):
                    assert (t["slot"], t["move"], t["action"], t["done"]) == (
                        j["slot"], j["move"], j["action"], j["done"]
                    )
                    assert t["reward"] == j["reward"] and t["score"] == j["score"]
            assert len(tres) == len(jres) > 0, f"dispatch {step}"
        assert tsvc.dispatch_count == jsvc.dispatch_count == dispatches
        summaries = [
            (tsvc.close_session(ts.sid), jsvc.close_session(js.sid))
            for js, ts in zip(jsess, tsess, strict=True)
        ]
        if net == "stub":
            assert all(t == j for t, j in summaries)


class TestService:
    def test_session_slots_admit_retire_and_masked_step(self, tiny_env_config):
        env = TriangleEnv(torch_cfg(tiny_env_config), device=CPU)
        slots = SessionSlots(env, 4)
        a, b, c, d = slots.admit_many(rng.split(rng.PRNGKey(0), 4))
        assert [s.slot for s in (a, b, c, d)] == [0, 1, 2, 3]
        with pytest.raises(RuntimeError):
            slots.admit(rng.PRNGKey(9))
        slots.retire(b.sid)
        slots.retire(d.sid)
        assert slots.states.done[1] and slots.states.done[3]
        assert slots.admit(rng.PRNGKey(5)).slot == 1
        before = slots.states.map(torch.clone)
        actions = env.valid_action_mask(slots.states).to(torch.int64).argmax(dim=1)
        slots.step(actions, np.array([True, False, True, False]))
        for name in before.__dataclass_fields__:
            old, new = getattr(before, name), getattr(slots.states, name)
            assert torch.equal(old[[1, 3]], new[[1, 3]]), name
        assert int(slots.states.step_count[0]) == 1
        scores, steps, done = slots.host_results()
        assert steps.tolist() == [1, 0, 1, 0] and scores.shape == done.shape == (4,)

    def test_request_queue_and_weight_reload(self, tiny_env_config, tiny_mcts_config):
        _, tsvc, _ = _service_pair(tiny_env_config, tiny_mcts_config, "real")
        assert tsvc.dispatch() == []
        (s,) = tsvc.open_sessions(rng.split(rng.PRNGKey(2), 1))
        other = tsvc.open_session(seed=4)
        assert (s.slot, other.slot) == (0, 1) and tsvc.sessions.live_count == 2
        tsvc.close_session(other.sid)
        tsvc.request_move(s.sid)
        with pytest.raises(RuntimeError):
            tsvc.request_move(s.sid)
        version = tsvc.net.weights_version
        assert tsvc.reload_weights(tsvc.net.get_weights()) == 1
        assert tsvc.net.weights_version == version + 1
        (res,) = tsvc.dispatch()
        assert res["sid"] == s.sid and res["latency_ms"] >= res["queue_wait_ms"] >= 0
        assert tsvc.serve_stats()["serve_dispatches"] == 1

    def test_int8_dispatches_match_jax(self, tiny_env_config, tiny_mcts_config):
        """Both services under INFERENCE_PRECISION="int8": each searches
        with its own int8 copy of the same weights (float32 compute, so
        the two forwards read the same dequantized weights) and serves
        the JAX service's root priors and values within `NET_ATOL`."""
        jsvc, tsvc, jouts = _service_pair(
            tiny_env_config, tiny_mcts_config, "real", INFERENCE_PRECISION="int8"
        )
        jsess, tsess = _open_same_sessions(jsvc, tsvc, 3)
        for _ in range(3):
            for js, ts in zip(jsess, tsess, strict=True):
                if not js.done:
                    jsvc.request_move(js.sid)
                    tsvc.request_move(ts.sid)
            jres, tres = jsvc.dispatch(), tsvc.dispatch()
            assert len(tres) == len(jres) > 0
            jout, tout = jouts[-1], tsvc.last_output
            np.testing.assert_allclose(
                tout.root_prior.numpy(), np.asarray(jout.root_prior), rtol=0, atol=NET_ATOL
            )
            np.testing.assert_allclose(
                tout.root_value.numpy(), np.asarray(jout.root_value), rtol=0, atol=NET_ATOL
            )
        assert tsvc.mcts.model is tsvc._serve_variables()
        assert tsvc.mcts.model.precision == "int8"

    def test_loadgen_serves_every_session(self, tiny_env_config, tiny_mcts_config):
        _, tsvc, _ = _service_pair(tiny_env_config, tiny_mcts_config, "stub")
        reloads = []
        stats = run_simulated_load(
            tsvc, total_sessions=6, concurrency=3, max_moves=3, seed=1,
            reload_hook=lambda svc, n: reloads.append(svc.reload_weights()) if n == 2 else None,
        )
        assert stats["sessions_served"] == 6
        assert stats["moves_served"] <= 6 * 3 and stats["moves_served"] >= 6
        assert stats["weight_reloads"] == 1 and reloads == [1]
        assert tsvc.sessions.live_count == 0 and tsvc.queue_depth == 0
