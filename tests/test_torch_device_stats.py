"""Parity of the port's device telemetry plane (`telemetry/device_stats.py`,
the search and PER stat-packs, the progress beacons, `observe_search`,
the dispatch watchdog's near-deadline warning) with the JAX package.

Host code is held equal on the same inputs: the enable state and its
environment overrides, the folds and merges, the ledger record and its
summaries, the beacon readers, the anomaly latches and the watchdog.
A search's stat-pack is held against JAX's `_stat_pack` on the same
tree (the exact stub net on both sides, JAX's noise injected): the
depth histogram and the |value| maximum exactly; the means over the
games (concentration, occupancy, reuse share) within 1e-6 relative
(XLA's float32 mean rounds on its order of summation, the port's
float64 mean does not), the root entropy within 1e-6 relative (a log
and a sum in each framework). One armed megastep on the CPU writes the
same multiset of (phase, index) beacon rows as the JAX megastep at the
same config (JAX's callbacks are unordered, so no order is compared).
"""

import json
from collections import Counter

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
from alphatriangle_tpu.telemetry import anomaly as janomaly  # noqa: E402
from alphatriangle_tpu.telemetry import device_stats as jds  # noqa: E402
from alphatriangle_tpu.telemetry import flight as jflight  # noqa: E402
from alphatriangle_tpu_torch.config import TelemetryConfig  # noqa: E402
from alphatriangle_tpu_torch.env import TriangleEnv  # noqa: E402
from alphatriangle_tpu_torch.features import FeatureExtractor  # noqa: E402
from alphatriangle_tpu_torch.mcts import BatchedMCTS, GumbelMCTS, select_root_actions  # noqa: E402
from alphatriangle_tpu_torch.nn.model import value_support  # noqa: E402
from alphatriangle_tpu_torch.ops import KERNELS  # noqa: E402
from alphatriangle_tpu_torch.ops import beacon as tbeacon  # noqa: E402
from alphatriangle_tpu_torch.rl.megastep import MegastepRunner  # noqa: E402
from alphatriangle_tpu_torch import telemetry as telemetry_pkg  # noqa: E402
from alphatriangle_tpu_torch.telemetry import RunTelemetry  # noqa: E402
from alphatriangle_tpu_torch.telemetry import anomaly as tanomaly  # noqa: E402
from alphatriangle_tpu_torch.telemetry import device_stats as tds  # noqa: E402
from alphatriangle_tpu_torch.telemetry import flight as tflight  # noqa: E402
from alphatriangle_tpu_torch.training import setup_training_components  # noqa: E402
from test_torch_megastep import _jax_side, _warm_up, make_cfg  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    CPU,
    JaxExactStub,
    TorchExactStub,
    converted_state_dict,
    inject_jax_noise,
    run_root,
    small_model_config,
    to_torch_state,
    torch_cfg,
    torch_key,
)

ENTROPY_RTOL = 1e-6  # a log and a sum, in each framework's order
# The means over the games: XLA's CPU mean is a float32 sum in order
# times float32(1/B), the port's a float64 mean of the same float32
# values (exact, so order-free). For B <= 8 games the float32 sum is
# off by at most (B - 1) roundings of 2^-24 relative and the product by
# one more: under 1e-6 relative.
MEAN_RTOL = 1e-6
EXACT = ("depth_hist", "value_abs_max")
MEANS = ("root_concentration", "occupancy", "reuse_frac")
PACKAGES = {"jax": jds, "torch": tds}


@pytest.fixture(autouse=True)
def _jax_noise(monkeypatch):
    inject_jax_noise(monkeypatch)


@pytest.fixture
def stats_on():
    """Both packages' stat-pack flag on while the engines are built (the
    autouse fixture puts the defaults back after the test)."""
    jds.set_device_stats(True)
    tds.set_device_stats(True)
    yield


# --- enable state ------------------------------------------------------------


def _enable_trace(mod, monkeypatch) -> list:
    """The enable state's answers through a fixed script of settings."""
    out = []
    mod.reset_device_stats_state()
    out.append((mod.device_stats_enabled(), mod.beacons_armed(), mod.beacon_every()))
    mod.set_device_stats(True)
    out.append((mod.device_stats_enabled(), mod.device_stats_signature()))
    monkeypatch.setenv(mod.DEVICE_STATS_ENV, "0")
    out.append(mod.device_stats_enabled())
    monkeypatch.setenv(mod.DEVICE_STATS_ENV, "1")
    mod.set_device_stats(False)
    out.append(mod.device_stats_enabled())
    monkeypatch.setenv(mod.DEVICE_STATS_ENV, "")
    out.append(mod.device_stats_enabled())
    monkeypatch.delenv(mod.DEVICE_STATS_ENV)
    # Beacons: the environment is read once until a reset.
    monkeypatch.setenv(mod.BEACONS_ENV, "1")
    out.append(mod.beacons_armed())  # cached False from above
    mod.reset_device_stats_state()
    monkeypatch.setenv(mod.BEACON_EVERY_ENV, "3")
    out.append((mod.beacons_armed(), mod.beacon_every(), mod.beacon_signature()))
    mod.disarm_beacons()
    out.append(mod.beacons_armed())
    mod.arm_beacons(5)
    out.append((mod.beacons_armed(), mod.beacon_every(), mod.beacon_signature()))
    mod.reset_device_stats_state()
    monkeypatch.setenv(mod.BEACON_EVERY_ENV, "x")
    monkeypatch.setenv(mod.BEACONS_ENV, "0")
    out.append((mod.beacons_armed(), mod.beacon_every(), mod.DEPTH_BINS))
    for name in (mod.BEACONS_ENV, mod.BEACON_EVERY_ENV):
        monkeypatch.delenv(name)
    mod.reset_device_stats_state()
    return out


def test_enable_state_and_environment_match_jax(monkeypatch):
    got = _enable_trace(tds, monkeypatch)
    want = _enable_trace(jds, monkeypatch)
    assert got == want
    assert got[-1] == (False, tds.DEFAULT_BEACON_EVERY, 16)


# --- folds, records, summaries --------------------------------------------------


def _stat_dicts(seed: int, t: int):
    rng = np.random.default_rng(seed)
    stacked = {
        "depth_hist": rng.integers(0, 50, (t, tds.DEPTH_BINS)).astype(np.float32),
        "root_entropy": rng.random(t).astype(np.float32) * 3,
        "root_concentration": rng.random(t).astype(np.float32),
        "value_abs_max": rng.random(t).astype(np.float32) * 20,
        "occupancy": rng.random(t).astype(np.float32),
        "reuse_frac": rng.random(t).astype(np.float32) * 0.5,
    }
    return stacked


@pytest.mark.parametrize("t", [1, 5])
def test_folds_and_records_match_jax(t):
    stacked = _stat_dicts(t, t)
    single = {k: v[0] for k, v in stacked.items()}
    # The port's packed form unpacks to the JAX leaves.
    pack = np.concatenate(
        [stacked["depth_hist"]] + [stacked[k][:, None] for k in tds.SEARCH_SCALARS], axis=1
    ).astype(np.float64)
    unpacked = tds.unpack_search_stats(pack)
    for key, val in stacked.items():
        np.testing.assert_array_equal(unpacked[key], val.astype(np.float64))
    for stats in (stacked, single, {}, None, {"root_entropy": np.float32(0.5)}):
        assert tds.fold_search_stats(stats) == jds.fold_search_stats(stats)
    folds = [jds.fold_search_stats(_stat_dicts(s, t)) for s in range(4)]
    folds += [None, {}, {"root_entropy": float("nan"), "depth_hist": [1.0, float("inf")]}]
    assert tds.merge_search_folds(folds) == jds.merge_search_folds(folds)
    assert tds.merge_search_folds([None]) is jds.merge_search_folds([None]) is None
    rng = np.random.default_rng(t)
    ends = rng.random((t, 4)) < 0.3
    rewards = rng.normal(size=(t, 4)).astype(np.float32)
    assert tds.rollout_chunk_stats(ends, rewards) == jds.rollout_chunk_stats(ends, rewards)
    assert tds.rollout_chunk_stats(ends[0], rewards[0]) is None
    assert tds.unpack_per_stats(np.array([3.5, 0.25, 1.0])) == {
        "priority_skew": 3.5, "is_weight_min": 0.25, "is_weight_max": 1.0,
    }
    legs = dict(
        search=folds[0], rollout=tds.rollout_chunk_stats(ends, rewards),
        per={"priority_skew": 2.0, "is_weight_min": 0.5, "is_weight_max": 1.0},
        learner={"grad_norm_max": 3.0, "update_norm_max": 0.01},
    )
    records = []
    for step in range(3):
        rec = tds.device_stats_record(step, program="megastep/t2_k2", now=100.0 + step, **legs)
        assert rec == jds.device_stats_record(step, program="megastep/t2_k2", now=100.0 + step, **legs)
        records.append(rec)
    serve = tds.device_stats_record(7, serve=folds[1], now=200.0)
    assert serve == jds.device_stats_record(7, serve=folds[1], now=200.0)
    records += [serve, {"kind": "util", "step": 1}]
    assert tds.device_stats_record(1, search=None, serve={}) is None
    assert tds.summarize_device_stats(records) == jds.summarize_device_stats(records)
    assert tds.device_stats_json(records) == jds.device_stats_json(records)
    assert tds.summarize_device_stats([{"kind": "util"}]) is None


def test_beacon_rows_read_both_ways(tmp_path):
    """Rows the port writes (the CPU path: at the call) read with both
    readers, and the JAX writer's rows with the port's."""
    tds.attach_beacon_run_dir(tmp_path / "torch")
    tds.arm_beacons(2)
    tds.note_dispatch("serve/b4")
    for k in range(5):
        tds.emit_beacon("search_wave", k, every=tds.beacon_every(), device=torch.device("cpu"))
    tds.note_dispatch("megastep/t2_k2")
    tds.emit_beacon("learner_step", 7)
    jds.attach_beacon_run_dir(tmp_path / "jax")
    jds.note_dispatch("serve/b4")
    for k in (0, 2, 4):
        jds._write_beacon_row("search_wave", k)
    jds.note_dispatch("megastep/t2_k2")
    jds._write_beacon_row("learner_step", 7)

    def strip(rows):
        return [{k: r[k] for k in ("kind", "program", "phase", "index")} for r in rows]

    for run in ("torch", "jax"):
        rows = tds.read_beacons(tmp_path / run / tds.BEACONS_FILENAME)
        assert strip(rows) == strip(jds.read_beacons(tmp_path / run / jds.BEACONS_FILENAME))
        assert tds.last_beacon(tmp_path / run) == jds.last_beacon(tmp_path / run) == rows[-1]
        assert tds.describe_beacon(rows[-1]) == jds.describe_beacon(rows[-1]) == (
            "megastep/t2_k2 phase=learner_step index=7"
        )
    assert strip(tds.read_beacons(tmp_path / "torch" / "beacons.jsonl")) == strip(
        tds.read_beacons(tmp_path / "jax" / "beacons.jsonl")
    )
    assert tds.last_beacon(tmp_path / "none") is jds.last_beacon(tmp_path / "none") is None
    assert tds.last_beacon(None) is None and tds.describe_beacon(None) is None
    # Unarmed: a site writes nothing.
    tds.disarm_beacons()
    tds.attach_beacon_run_dir(tmp_path / "quiet")
    tds.emit_beacon("search_wave", 0)
    assert not (tmp_path / "quiet" / "beacons.jsonl").exists()


def test_beacon_ring_drains_in_sequence(tmp_path):
    """The card's ring protocol with the plain writer: rows come out in
    the order written, a wrapped-over slot counts as dropped, and a stop
    drains what is left."""
    tds.attach_beacon_run_dir(tmp_path)
    ring = tbeacon.BeaconRing("cpu", slots=4, poll_s=3600.0)
    try:
        for i in range(3):
            ring.emit("search_wave", i, "serve/b8")
        assert ring.drain() == 3 and ring.drain() == 0
        for i in range(6):  # wraps: the first two of these are overwritten
            ring.emit("learner_step", 10 + i, None)
        assert ring.drain() == 4 and ring.dropped == 2
        ring.emit("ring_scatter", 3, "megastep/t2_k2")
    finally:
        ring.stop()
    rows = [(r["phase"], r["index"], r["program"]) for r in tds.read_beacons(tmp_path / "beacons.jsonl")]
    assert rows == [("search_wave", i, "serve/b8") for i in range(3)] + [
        ("learner_step", 10 + i, None) for i in range(2, 6)
    ] + [("ring_scatter", 3, "megastep/t2_k2")]
    # The plain writer is the kernel's function: seq, ids, the counter.
    counter, host = torch.zeros(1, dtype=torch.int64), torch.zeros((2, 4), dtype=torch.int64)
    for i in range(3):
        tbeacon.beacon_plain(counter, host, 1, 5 + i, 2)
    assert int(counter[0]) == 3
    assert host.tolist() == [[3, 1, 7, 2], [2, 1, 6, 2]]


def test_close_drains_the_ring_and_lets_go_of_the_run(tmp_path, monkeypatch):
    """`RunTelemetry.close` writes the rows the ring has published but not
    drained into its run's file, and no later row goes there; a close
    leaves another run's attachment as it is."""
    ring = tbeacon.BeaconRing("cpu", poll_s=3600.0)  # drained only when asked
    monkeypatch.setitem(tbeacon._RINGS, torch.device("cpu"), ring)
    a, b = tmp_path / "a", tmp_path / "b"
    tel_a = RunTelemetry(TelemetryConfig(), run_dir=a)
    ring.emit("search_wave", 0, "serve/b8")
    ring.emit("search_wave", 8, "serve/b8")
    tel_a.close()
    tds.arm_beacons(1)
    tds.emit_beacon("learner_step", 1)  # no run attached: dropped
    tel_b = RunTelemetry(TelemetryConfig(), run_dir=b)
    tel_c = RunTelemetry(TelemetryConfig(), run_dir=tmp_path / "c")
    tel_b.close()  # c attached last: its rows stay c's
    tds.emit_beacon("learner_step", 2)
    tel_c.close()
    tds.emit_beacon("learner_step", 3)

    def rows(d):
        return [(r["phase"], r["index"]) for r in tds.read_beacons(d / tds.BEACONS_FILENAME)]

    assert rows(a) == [("search_wave", 0), ("search_wave", 8)]
    assert rows(b) == [] and rows(tmp_path / "c") == [("learner_step", 2)]
    ring.stop()


# --- the anomaly screen and the watchdog -----------------------------------------


def test_observe_search_latches_match_jax():
    legs = [
        {"root_entropy": 1.2, "occupancy": 0.5, "value_abs_max": 1.0},
        {"root_entropy": 0.01, "occupancy": 0.99},
        {"root_entropy": 0.02, "occupancy": 0.995, "value_abs_max": float("nan")},
        {"root_entropy": 0.9, "occupancy": 0.4},
        {"root_entropy": 0.0, "occupancy": 1.0, "value_abs_max": 1.1},
        {"depth_hist": [1.0]},
        "not a leg",
    ] + [{"value_abs_max": 1.0 + 0.01 * i} for i in range(25)] + [{"value_abs_max": 500.0}]
    got, want = tanomaly.AnomalyDetector(), janomaly.AnomalyDetector()
    kinds = Counter()
    for step, leg in enumerate(legs):
        a, b = got.observe_search(leg, step), want.observe_search(leg, step)
        assert [(x.kind, x.metric, x.step) for x in a] == [(x.kind, x.metric, x.step) for x in b]
        assert [x.describe() for x in a] == [x.describe() for x in b]
        kinds.update(x.kind for x in a)
    # Each excursion fires once; the recovery at step 3 re-arms both.
    assert kinds == {"collapse": 2, "saturation": 2, "nonfinite": 1, "spike": 1}


class _Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def test_watchdog_warns_once_before_the_wedge(tmp_path):
    runs = {}
    for name, mod in (("jax", jflight), ("torch", tflight)):
        clock = _Clock(10.0)
        warned, wedged = [], []
        dog = mod.DispatchWatchdog(
            tmp_path / name, on_wedge=wedged.append, exit_on_wedge=False, clock=clock,
            warn_fraction=0.5, on_warn=warned.append,
        )
        dog.arm(1, program="serve/b16", family="serve", deadline_s=4.0)
        dog.arm(2, program="serve/b16", family="serve", deadline_s=40.0)
        clock.t = 11.5
        assert dog.check() is None and dog.warn_count == 0
        clock.t = 12.5
        assert dog.check() is None and dog.warn_count == 1
        clock.t = 13.0
        assert dog.check() is None and dog.warn_count == 1  # once per dispatch
        clock.t = 14.5
        report = dog.check()
        assert report is not None and dog.warn_count == 1 and len(wedged) == 1
        runs[name] = (warned, report)
    assert runs["torch"][0] == runs["jax"][0]
    assert runs["torch"][1]["last_beacon"] is runs["jax"][1]["last_beacon"] is None


def test_warn_hook_arms_beacons_and_the_wedge_names_the_phase(tmp_path, monkeypatch):
    """RunTelemetry's warning hook arms the beacons once; the rows the
    work after it writes reach the wedge report, which both packages'
    classifiers name."""
    monkeypatch.setenv(tds.BEACON_EVERY_ENV, "3")
    clock = _Clock(0.0)
    tel = RunTelemetry(TelemetryConfig(), run_dir=tmp_path, clock=clock)
    tel.dispatch_watchdog.exit_on_wedge = False
    armed = []

    def counting(every=None):
        armed.append(every)
        tds.arm_beacons(every)

    monkeypatch.setattr(telemetry_pkg, "arm_beacons", counting)
    try:
        span = tel.flight.begin("megastep", "megastep/t2_k2", avals="B4")
        deadline = tel.flight.deadline_s(None)
        clock.t = 0.6 * deadline
        assert tel.dispatch_watchdog.check() is None
        assert armed == [None] and tds.beacons_armed() and tds.beacon_every() == 3
        clock.t = 0.7 * deadline
        tel.dispatch_watchdog.check()
        assert armed == [None]  # the hook arms once
        tds.note_dispatch("megastep/t2_k2")
        for k in range(4):
            tds.emit_beacon("search_wave", k, every=tds.beacon_every())
        clock.t = 1.5 * deadline
        report = tel.dispatch_watchdog.check()
        span.seal()
    finally:
        tel.close()
    assert report["last_beacon"]["phase"] == "search_wave" and report["last_beacon"]["index"] == 3
    on_disk = tflight.read_wedge_report(tmp_path / tflight.WEDGE_REPORT_FILENAME)
    assert on_disk["last_beacon"] == report["last_beacon"]
    flight = tflight.read_flight(tmp_path / tflight.FLIGHT_FILENAME)
    verdicts = [mod.classify_run(flight, wedge=on_disk) for mod in (tflight, jflight)]
    assert verdicts[0] == verdicts[1]
    assert verdicts[0]["last_beacon"] == report["last_beacon"]
    assert "last beacon: megastep/t2_k2 phase=search_wave index=3" in verdicts[0]["detail"]
    # Without a wedge report the caller's row is used.
    unsealed = [r for r in flight if r.get("phase") == "intent"]
    got = tflight.classify_run(unsealed, beacon=report["last_beacon"])
    assert got == jflight.classify_run(unsealed, beacon=report["last_beacon"])


# --- search stat-packs against JAX's _stat_pack --------------------------------------


def _world(jenv_cfg, mcts_cfg, gumbel: bool, exploit: bool = False):
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
    states = jenv.reset_batch(jax.random.split(jax.random.PRNGKey(seed), batch))
    pick = np.random.default_rng(seed)
    for _ in range(moves):
        mask = np.asarray(jenv.valid_mask_batch(states))
        acts = np.array([pick.choice(np.flatnonzero(m)) if m.any() else 0 for m in mask])
        states, _, _ = jenv.step_batch(states, jnp.asarray(acts, jnp.int32))
    done = np.asarray(states.done).copy()
    done[-1] = True
    return states.replace(done=jnp.asarray(done))


def _assert_pack(tpack, jstats, sims: int, batch: int, msg: str):
    got = tds.unpack_search_stats(tpack.numpy())
    want = jax.device_get(jstats)
    assert tpack.dtype == torch.float64 and tpack.shape == (tds.SEARCH_PACK_SIZE,)
    for key in EXACT:
        np.testing.assert_array_equal(
            got[key], np.asarray(want[key]).astype(np.float64), err_msg=f"{msg} {key}"
        )
    for key in MEANS:
        np.testing.assert_allclose(
            got[key], np.asarray(want[key]), rtol=MEAN_RTOL, atol=0, err_msg=f"{msg} {key}"
        )
    np.testing.assert_allclose(
        got["root_entropy"], np.asarray(want["root_entropy"]), rtol=ENTROPY_RTOL, atol=0,
        err_msg=f"{msg} root_entropy",
    )
    assert got["depth_hist"].sum() == sims * batch  # one count per simulation
    assert 0.0 <= got["root_entropy"] <= np.log(360.0)


SEARCH_CASES = [
    # (board, sims, depth, wave, gumbel, exploit, moves)
    ("tiny", 8, 5, 4, False, False, 3),
    ("tiny", 16, 4, 1, False, False, 0),
    ("flagship", 16, 8, 8, False, False, 2),
    ("tiny", 16, 5, 4, True, False, 3),
    ("flagship", 32, 5, 8, True, True, 1),
]


@pytest.mark.parametrize("board,sims,depth,wave,gumbel,exploit,moves", SEARCH_CASES)
def test_search_stat_pack_matches_jax(
    stats_on, tiny_env_config, board, sims, depth, wave, gumbel, exploit, moves
):
    jenv_cfg = tiny_env_config if board == "tiny" else EnvConfig()
    cfg = AlphaTriangleMCTSConfig(
        max_simulations=sims, max_depth=depth, mcts_batch_size=wave, gumbel_m=8,
        root_selection="gumbel" if gumbel else "puct",
    )
    jm, tm, jenv = _world(jenv_cfg, cfg, gumbel, exploit)
    assert tm.device_stats and jm.device_stats
    roots = _roots(jenv, 5, seed=sims + moves, moves=moves)
    key = jax.random.PRNGKey(sims * 3 + depth)
    jout = jm.search({}, roots, key)
    before = {k: v.launches for k, v in KERNELS.items()}
    tout = tm.search(to_torch_state(roots), torch_key(key))
    assert {k: v.launches for k, v in KERNELS.items()} == before  # CPU: plain versions
    np.testing.assert_array_equal(tout.visit_counts.numpy(), np.asarray(jout.visit_counts))
    _assert_pack(tout.stats, jout.stats, sims, 5, f"{board} {sims} gumbel={gumbel}")


def test_stat_pack_off_by_default(tiny_env_config):
    cfg = AlphaTriangleMCTSConfig(max_simulations=8, max_depth=4, mcts_batch_size=4)
    jm, tm, jenv = _world(tiny_env_config, cfg, False)
    assert not tm.device_stats
    out = tm.search(to_torch_state(_roots(jenv, 2, 1, 0)), torch_key(jax.random.PRNGKey(0)))
    assert out.stats is None


def test_carried_search_stat_pack_matches_jax(stats_on, tiny_env_config):
    cfg = AlphaTriangleMCTSConfig(
        max_simulations=8, max_depth=4, mcts_batch_size=4, tree_reuse=True,
    )
    jm, tm, jenv = _world(tiny_env_config, cfg, False)
    jsearch = jax.jit(jm._search_carried)
    jpromote = jax.jit(jm.promote)
    states = _roots(jenv, 4, seed=5, moves=1)
    jc, tc = jm.zero_carried(states), tm.zero_carried(to_torch_state(states))
    reuse = []
    for move in range(3):
        key = jax.random.PRNGKey(60 + move)
        jout, jtree, _ = jsearch({}, states, key, jc)
        tout, ttree, _ = tm._search_carried(to_torch_state(states), torch_key(key), tc)
        np.testing.assert_array_equal(tout.visit_counts.numpy(), np.asarray(jout.visit_counts))
        _assert_pack(tout.stats, jout.stats, 8, 4, f"move {move}")
        reuse.append(tds.unpack_search_stats(tout.stats.numpy())["reuse_frac"])
        actions = np.asarray(jax_select(jout, False))
        np.testing.assert_array_equal(np.asarray(select_root_actions(tout, False)), actions)
        jc = jpromote(jtree, jnp.asarray(actions, jnp.int32))
        tc = tm.promote(ttree, torch.from_numpy(actions.astype(np.int64)))
        states, _, _ = jenv.step_batch(states, jnp.asarray(actions, jnp.int32))
    assert reuse[0] == 0.0 and max(reuse[1:]) > 0.0


# --- one armed megastep's beacon rows ---------------------------------------------------


def test_armed_megastep_beacon_rows_match_jax(
    tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
):
    jds.arm_beacons(1)
    tds.arm_beacons(1)
    jtc = make_cfg()
    jeng, jtrainer, jring, jrunner, jnet, _ = _jax_side(
        tiny_env_config, tiny_model_config, tiny_mcts_config, jtc
    )
    c = setup_training_components(
        torch_cfg(jtc), torch_cfg(tiny_env_config), torch_cfg(tiny_model_config),
        torch_cfg(tiny_mcts_config), persistence_config=run_root(tmp_path), device=CPU,
    )
    c.net.model.load_state_dict(converted_state_dict(jnet))
    assert isinstance(c.megastep, MegastepRunner)
    assert _warm_up(c.self_play, c.buffer, jtc) == _warm_up(jeng, jring, jtc)
    jax.effects_barrier()
    jrunner.sync_priorities_from_host()
    c.megastep.sync_priorities_from_host()
    jds.attach_beacon_run_dir(tmp_path / "jax")
    tds.attach_beacon_run_dir(tmp_path / "torch")
    k = jtc.FUSED_LEARNER_STEPS
    jrunner.run_megastep(jtc.ROLLOUT_CHUNK_MOVES, k)
    jax.effects_barrier()
    c.megastep.run_megastep(jtc.ROLLOUT_CHUNK_MOVES, k)
    rows = {
        name: mod.read_beacons(tmp_path / name / "beacons.jsonl") for name, mod in PACKAGES.items()
    }
    got = Counter((r["phase"], r["index"]) for r in rows["torch"])
    want = Counter((r["phase"], r["index"]) for r in rows["jax"])
    assert got == want
    waves = c.self_play.mcts.num_waves
    assert got[("search_wave", 0)] == jtc.ROLLOUT_CHUNK_MOVES and ("search_wave", waves - 1) in got
    assert {p for p, _ in got} == {"search_wave", "rollout_chunk", "ring_scatter", "learner_step"}
    # The port names the megastep on every row (the host's order of
    # enqueues is the card's order of execution on one stream).
    assert {r["program"] for r in rows["torch"]} == {f"megastep/t{jtc.ROLLOUT_CHUNK_MOVES}_k{k}"}
    # The megastep's record carries every leg.
    ds = c.megastep.last_device_stats
    assert set(ds) == {"search", "rollout", "per", "learner"} and all(ds.values())
    assert sum(ds["search"]["depth_hist"]) == (
        jtc.ROLLOUT_CHUNK_MOVES * jtc.SELF_PLAY_BATCH_SIZE * tiny_mcts_config.max_simulations
    )
    c.stats.close()
    json.dumps(ds)
