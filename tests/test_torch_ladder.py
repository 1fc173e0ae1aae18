"""Parity of the port's serving bucket ladder (`serving/buckets.py`,
`SessionSlots.migrate`, `PolicyService`'s rung walk, `cli serve
--buckets`) with the JAX package's.

- `BucketLadder` / `default_rungs`: every lookup equal over a list of
  specs (integers: exact).
- `migrate`: every state tensor bit-equal to the JAX migration's, for a
  walk up and a walk down; pad lanes equal a fresh array's.
- Lane isolation across a switch (the tracked session's actions and
  scores equal solo and in a churning crowd), carried trees dropped by
  a switch, and `cli serve --buckets` on the CPU.

The JAX storm and the single-rung service against the JAX service are
`tests/test_torch_ladder_storm.py`.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from alphatriangle_tpu.config import AlphaTriangleMCTSConfig as JaxMCTSConfig  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.serving import BucketLadder as JaxLadder  # noqa: E402
from alphatriangle_tpu.serving import default_rungs as jax_default_rungs  # noqa: E402
from alphatriangle_tpu.serving import buckets as jax_buckets  # noqa: E402
from alphatriangle_tpu.serving.session import SessionSlots as JaxSlots  # noqa: E402
from alphatriangle_tpu_torch import cli, rng  # noqa: E402
from alphatriangle_tpu_torch.config import PersistenceConfig, TrainConfig  # noqa: E402
from alphatriangle_tpu_torch.env import TriangleEnv  # noqa: E402
from alphatriangle_tpu_torch.features import FeatureExtractor  # noqa: E402
from alphatriangle_tpu_torch.mcts import BatchedMCTS  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork  # noqa: E402
from alphatriangle_tpu_torch.rl import Trainer  # noqa: E402
from alphatriangle_tpu_torch.serving import buckets  # noqa: E402
from alphatriangle_tpu_torch.serving import (  # noqa: E402
    BucketLadder,
    PolicyService,
    SessionSlots,
    default_rungs,
)
from alphatriangle_tpu_torch.stats import CheckpointManager  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    CPU,
    inject_jax_noise,
    small_model_config,
    to_torch_state,
    torch_cfg,
    torch_key,
)


@pytest.fixture(autouse=True)
def _jax_noise(monkeypatch):
    inject_jax_noise(monkeypatch)


# --- the ladder itself -------------------------------------------------------

LADDER_SPECS = [
    ("16,4,8,4", 16),
    ("2,4,8", None),
    ("2,4,8", 3),
    ("8;16", 4),
    ([64, 256, 1024], 64),
    ((7,), None),
    (None, 8),
    (None, 13),
    ("", 5),
    (None, 1),
]


def _ladder_facts(ladder) -> dict:
    top = ladder.max_rung
    return {
        "rungs": ladder.rungs,
        "min": ladder.min_rung,
        "max": top,
        "contains": [r in ladder for r in range(top + 2)],
        "rung_for": [ladder.rung_for(d) for d in range(top + 3)],
        "at_or_below": [ladder.rung_at_or_below(t / 2) for t in range(2 * top + 3)],
        "up": [ladder.up(r) for r in ladder.rungs],
        "down": [ladder.down(r) for r in ladder.rungs],
        "walk_down": [ladder.walk_down(r, k) for r in ladder.rungs for k in range(-1, 4)],
        "index": [ladder.index(r) for r in ladder.rungs],
    }


@pytest.mark.parametrize("spec,base", LADDER_SPECS)
def test_ladder_matches_jax(spec, base):
    ours = BucketLadder.from_spec(spec, base=base)
    ref = JaxLadder.from_spec(spec, base=base)
    assert _ladder_facts(ours) == _ladder_facts(ref)
    assert BucketLadder.from_spec(ours) is ours
    assert BucketLadder.single(base or 3).rungs == JaxLadder.single(base or 3).rungs


@pytest.mark.parametrize("base,floor", [(1, 1), (8, 1), (13, 1), (64, 4), (100, 7), (3, 5)])
def test_default_rungs_match_jax(base, floor):
    assert default_rungs(base, floor=floor) == jax_default_rungs(base, floor=floor)


@pytest.mark.parametrize("make", [
    lambda m: m.BucketLadder.from_spec(None),
    lambda m: m.BucketLadder(()),
    lambda m: m.BucketLadder((0, 2)),
    lambda m: m.default_rungs(0),
], ids=["no-spec-no-base", "empty", "zero-rung", "zero-base"])
def test_ladder_errors_match_jax(make):
    for module in (buckets, jax_buckets):
        with pytest.raises(ValueError):
            make(module)


# --- migration ----------------------------------------------------------------


def _assert_states_equal(tstates, jstates):
    want = to_torch_state(jstates)
    for name in want.__dataclass_fields__:
        got = getattr(tstates, name)
        assert torch.equal(got.to(getattr(want, name).dtype), getattr(want, name)), name


def _slot_view(slots):
    return sorted((s.sid, s.slot, s.pending_since) for s in slots.live_sessions())


@pytest.mark.parametrize("path", [(6, 16, 8), (16, 8, 5)])
def test_migrate_matches_jax(tiny_env_config, path):
    """Admit, retire around, then migrate along `path` (the first entry is
    the starting width): every state tensor bit-equal to the JAX
    migration's, the same sessions in the same lanes, pending requests
    and totals carried; the pad lanes those of a fresh array."""
    start, *widths = path
    jenv = JaxEnv(tiny_env_config)
    tenv = TriangleEnv(torch_cfg(tiny_env_config), device=CPU)
    jslots, tslots = JaxSlots(jenv, start, pad_seed=3), SessionSlots(tenv, start, pad_seed=3)
    keys = jax.random.split(jax.random.PRNGKey(11), start)
    jsess, tsess = jslots.admit_many(keys), tslots.admit_many(torch_key(keys))
    actions = np.arange(start) % tiny_env_config.action_dim
    mask = np.arange(start) % 3 != 1
    jslots.step(actions, mask)
    tslots.step(torch.as_tensor(actions), mask)
    for i in [i for i in range(start) if i % 3 == 0 or i >= 7]:  # four stay live
        assert jslots.retire(jsess[i].sid) == tslots.retire(tsess[i].sid)
    jsess[2].pending_since = tsess[2].pending_since = 12.5
    for width in widths:
        jslots, tslots = jslots.migrate(width, pad_seed=5), tslots.migrate(width, pad_seed=5)
        assert tslots.slots == jslots.slots == width
        _assert_states_equal(tslots.states, jslots.states)
        assert _slot_view(tslots) == _slot_view(jslots)
        assert sorted(tslots._free) == sorted(jslots._free)
        assert (tslots.admitted_total, tslots.retired_total) == (jslots.admitted_total, jslots.retired_total)
        live = tslots.live_count
        fresh = SessionSlots(tenv, width, pad_seed=5).states
        for name in fresh.__dataclass_fields__:
            assert torch.equal(getattr(tslots.states, name)[live:], getattr(fresh, name)[live:]), name
    # The sid counter carries over: the next admission continues it.
    nxt = jax.random.PRNGKey(99)
    assert tslots.admit(torch_key(nxt)).sid == jslots.admit(nxt).sid
    with pytest.raises(RuntimeError):
        tslots.migrate(1)


# --- the service's walk ---------------------------------------------------------


def _small_search():
    return JaxMCTSConfig(max_simulations=4, max_depth=3, mcts_batch_size=4)


def drive_session(service, reset_key, dispatch_keys, churn=False, seed=7, switch=None):
    """`tests/test_serving.py::drive_session` on the port: one tracked
    session (slot 0) driven to its end with fixed dispatch keys, with
    or without churning neighbours, `switch=(i, rung)` forcing a rung
    switch after dispatch i. Returns its (actions, scores)."""
    tracked = service.open_session(reset_key)
    assert tracked.slot == 0
    if churn:
        for o in service.open_sessions(rng.split(rng.PRNGKey(seed), 3)):
            service.request_move(o.sid)
    actions, scores = [], []
    for i, key in enumerate(dispatch_keys):
        service.request_move(tracked.sid)
        results = service.dispatch(key)
        mine = next(r for r in results if r["sid"] == tracked.sid)
        actions.append(mine["action"])
        scores.append(mine["score"])
        if churn:
            for r in results:
                if r["sid"] == tracked.sid:
                    continue
                if r["done"] or i % 2:
                    service.close_session(r["sid"])
                else:
                    service.request_move(r["sid"])
            n_fresh = min(2, service.sessions.free_count)
            if n_fresh:
                for o in service.open_sessions(rng.split(rng.PRNGKey(1000 + seed + i), n_fresh)):
                    service.request_move(o.sid)
        if switch is not None and i == switch[0]:
            service._switch_rung(switch[1], "test")
        if mine["done"]:
            break
    return actions, scores


def test_lane_isolation_across_rung_switch(tiny_env_config, tiny_model_config):
    """A switch to 16 lanes after dispatch 1: the tracked session plays
    the same game solo as in a churning crowd (both switch at the same
    dispatch, so both run the same widths)."""
    env = TriangleEnv(torch_cfg(tiny_env_config), device=CPU)
    model_cfg = torch_cfg(tiny_model_config)
    fe = FeatureExtractor(env, model_cfg)
    net = NeuralNetwork(model_cfg, torch_cfg(tiny_env_config), seed=0, device=CPU)
    mcts = BatchedMCTS(env, fe, net.model, torch_cfg(_small_search()), net.support)
    keys = [rng.PRNGKey(100 + i) for i in range(10)]
    solo = drive_session(PolicyService(env, fe, net, mcts, slots=8, ladder="8,16"),
                         rng.PRNGKey(42), keys, switch=(1, 16))
    crowded_svc = PolicyService(env, fe, net, mcts, slots=8, ladder="8,16")
    crowded = drive_session(crowded_svc, rng.PRNGKey(42), keys, churn=True, switch=(1, 16))
    assert solo == crowded
    assert crowded_svc.rung_switches == 1 and len(solo[0]) > 2  # moves after the switch


def test_rung_switch_invalidates_carried_trees(tiny_env_config, tiny_model_config):
    """Under reuse a switch drops every carried tree: `_carry_ok` all
    False at the new width and zero trees of that width; the live
    sessions keep their identity, re-packed lowest-first, and are served
    at the new rung."""
    env = TriangleEnv(torch_cfg(tiny_env_config), device=CPU)
    model_cfg = torch_cfg(tiny_model_config)
    fe = FeatureExtractor(env, model_cfg)
    net = NeuralNetwork(model_cfg, torch_cfg(tiny_env_config), seed=0, device=CPU)
    cfg = torch_cfg(JaxMCTSConfig(max_simulations=8, max_depth=4, mcts_batch_size=4, tree_reuse=True))
    service = PolicyService(env, fe, net, BatchedMCTS(env, fe, net.model, cfg, net.support),
                            slots=8, ladder="8,16")
    sessions = service.open_sessions(rng.split(rng.PRNGKey(5), 3))
    for _ in range(2):
        for s in sessions:
            service.request_move(s.sid)
        service.dispatch()
    assert service._carry_ok.any()
    service._switch_rung(16, "test")
    assert service.sessions.slots == 16 and service._carry_ok.shape == (16,)
    assert not service._carry_ok.any()
    assert service._carried.valid.shape[0] == 16 and not bool(service._carried.valid.any())
    live = sorted(service.sessions.live_sessions(), key=lambda s: s.slot)
    assert [s.sid for s in live] == [s.sid for s in sessions] and [s.slot for s in live] == [0, 1, 2]
    for s in sessions:
        service.request_move(s.sid)
    assert len(service.dispatch()) == 3
    assert service._carry_ok[:3].any() and not service._carry_ok[3:].any()


def test_cli_serve_buckets(tmp_path, tiny_env_config, capsys):
    """`cli serve --buckets 2,4,8 --device cpu` of a tiny run: every rung
    warmed, the load up to the top rung, every session served and the
    report's ladder fields."""
    env_cfg = torch_cfg(tiny_env_config)
    model_cfg = torch_cfg(small_model_config(tiny_env_config))
    persistence = PersistenceConfig(ROOT_DATA_DIR=str(tmp_path), RUN_NAME="served")
    mgr = CheckpointManager(persistence)
    mgr.save_configs({"env": env_cfg, "model": model_cfg})
    trainer = Trainer(NeuralNetwork(model_cfg, env_cfg, seed=2, device=CPU), TrainConfig(RUN_NAME="served"))
    mgr.save(1, trainer.get_state())
    rc = cli.main([
        "serve", "--device", "cpu", "--run-name", "served", "--root-dir", str(tmp_path),
        "--slots", "2", "--buckets", "2,4,8", "--sims", "4", "--sessions", "12",
        "--max-moves", "4", "--reload-every", "0",
    ])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert report["buckets"] == [2, 4, 8] and report["slots"] == 2
    assert report["sessions_served"] == 12 and report["max_concurrency"] == 8
    assert report["rung_switches"] >= 1 and report["serve_rung_switches"] == report["rung_switches"]
    assert report["source"] == "step 1"
