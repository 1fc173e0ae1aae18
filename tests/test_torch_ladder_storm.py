"""The JAX bucket-ladder storm on the port's `PolicyService`
(`tests/test_serving.py::TestBucketLadder`: ladder "2,4,8", sustain 2,
20 sessions) and the single-rung service, both against the JAX service
dispatch for dispatch.

Both services search under the exact stub nets of `tests/torch_parity.py`
with the JAX Gumbel and gamma draws injected, so the rung after every
dispatch and every served result (slot, move, action, reward, done,
score) must be equal exactly. One JAX search serves every test of the
module, so each width compiles once; the storm is kept apart from
`tests/test_torch_ladder.py` so each file stays well inside its time.
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from alphatriangle_tpu.config import AlphaTriangleMCTSConfig as JaxMCTSConfig  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.mcts import BatchedMCTS as JaxMCTS  # noqa: E402
from alphatriangle_tpu.serving import PolicyService as JaxService  # noqa: E402
from alphatriangle_tpu.serving import run_simulated_load as jax_load  # noqa: E402
from alphatriangle_tpu_torch import rng  # noqa: E402
from alphatriangle_tpu_torch.env import TriangleEnv  # noqa: E402
from alphatriangle_tpu_torch.features import FeatureExtractor  # noqa: E402
from alphatriangle_tpu_torch.mcts import BatchedMCTS  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork  # noqa: E402
from alphatriangle_tpu_torch.serving import PolicyService, run_simulated_load  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import default_device_stats  # noqa: E402
from torch_parity import CPU, JaxExactStub, TorchExactStub, inject_jax_noise, torch_cfg  # noqa: E402


@pytest.fixture(autouse=True)
def _jax_noise(monkeypatch):
    inject_jax_noise(monkeypatch)


def _small_search():
    return JaxMCTSConfig(max_simulations=4, max_depth=3, mcts_batch_size=4)


@pytest.fixture(scope="module")
def stub_worlds(tiny_env_config, tiny_model_config):
    """The JAX and the port (env, extractor, net, search) under the exact
    stub nets, one per module: the JAX search compiles once per width."""
    default_device_stats()  # a search reads the stat-pack flag when built
    mcts_cfg = _small_search()
    jenv = JaxEnv(tiny_env_config)
    jfe = get_feature_extractor(jenv, tiny_model_config)
    # The stubs read no weights: a JAX service reads only these two.
    jnet = SimpleNamespace(variables={}, weights_version=0)
    tenv = TriangleEnv(torch_cfg(tiny_env_config), device=CPU)
    tfe = FeatureExtractor(tenv, torch_cfg(tiny_model_config))
    tnet = NeuralNetwork(torch_cfg(tiny_model_config), torch_cfg(tiny_env_config), device=CPU)
    adim, atoms = tiny_env_config.action_dim, tiny_model_config.NUM_VALUE_ATOMS
    jm = JaxMCTS(jenv, jfe, JaxExactStub(adim, atoms), mcts_cfg, jax.numpy.asarray(tnet.support.numpy()))
    tm = BatchedMCTS(tenv, tfe, TorchExactStub(adim, atoms), torch_cfg(mcts_cfg), tnet.support)
    return (jenv, jfe, jnet, jm), (tenv, tfe, tnet, tm)


def _service_pair(stub_worlds, slots, ladder, **kw):
    """A JAX and a port PolicyService under the exact stub nets."""
    (jenv, jfe, jnet, jm), (tenv, tfe, tnet, tm) = stub_worlds
    jsvc = JaxService(jenv, jfe, jnet, jm, slots=slots, rng_seed=5, ladder=ladder, **kw)
    tsvc = PolicyService(tenv, tfe, tnet, tm, slots=slots, rng_seed=5, ladder=ladder, **kw)
    return jsvc, tsvc


def _recorded(svc, log: list):
    """Wrap `svc.dispatch` to log each dispatch's results and the rung
    after it."""
    real = svc.dispatch

    def dispatch(*a, **kw):
        results = real(*a, **kw)
        log.append((
            [(r["sid"], r["slot"], r["move"], r["action"], r["reward"], r["done"], r["score"])
             for r in results],
            svc.sessions.slots,
        ))
        return results

    svc.dispatch = dispatch
    return svc


def test_storm_walks_like_jax(stub_worlds):
    """The JAX storm: a burst against a 2-slot base rung walks up, the
    drain walks back down, 20 sessions served, and every dispatch (its
    rung after, its results) equals the JAX service's."""
    jsvc, tsvc = _service_pair(stub_worlds, 2, "2,4,8", sustain=2)
    assert tsvc.ladder.rungs == jsvc.ladder.rungs == (2, 4, 8)
    assert tsvc.max_slots == jsvc.max_slots == 8
    tsvc.warm()  # a search at each width; touches no session
    assert tsvc.sessions.live_count == 0 and tsvc.dispatch_count == 0
    jlog, tlog = [], []
    kw = dict(total_sessions=20, concurrency=8, max_moves=6, seed=3)
    jstats = jax_load(_recorded(jsvc, jlog), **kw)
    tstats = run_simulated_load(_recorded(tsvc, tlog), **kw)
    assert tstats["sessions_served"] == jstats["sessions_served"] == 20
    assert tstats["dispatches"] == jstats["dispatches"] == len(tlog) == len(jlog)
    assert [rung for _, rung in tlog] == [rung for _, rung in jlog]
    assert tlog == jlog
    rungs = [rung for _, rung in tlog]
    assert tsvc.rung_switches == jsvc.rung_switches >= 2
    assert max(rungs) > 2 and rungs[-1] < max(rungs)
    stats = tsvc.serve_stats()
    assert stats["serve_bucket"] == tsvc.sessions.slots and stats["serve_rung_switches"] == tsvc.rung_switches


def test_no_ladder_is_the_single_rung_service(stub_worlds):
    """`ladder=None`: one rung at `slots`, never a switch, admission past
    it raises, and the served results equal the JAX single-rung
    service's dispatch for dispatch."""
    jsvc, tsvc = _service_pair(stub_worlds, 4, None)
    assert tsvc.ladder.rungs == (4,) and tsvc.max_slots == 4
    jlog, tlog = [], []
    kw = dict(total_sessions=7, concurrency=8, max_moves=4, seed=2)
    jax_load(_recorded(jsvc, jlog), **kw)
    run_simulated_load(_recorded(tsvc, tlog), **kw)
    assert tlog == jlog and {rung for _, rung in tlog} == {4}
    assert tsvc.rung_switches == 0
    tsvc.open_sessions(rng.split(rng.PRNGKey(1), 4))
    with pytest.raises(RuntimeError):
        tsvc.open_session(seed=3)
