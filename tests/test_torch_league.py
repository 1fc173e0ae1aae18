"""Parity of the port's league (`league/`, `config/league_config.py`,
`cli league`) with the JAX package's `alphatriangle_tpu/league/`.

- `LeagueConfig`: a JAX dump loads unchanged; the same bounds refuse.
- `LeaguePool`: one event sequence (members, results, promotion gate and
  its window reset) gives the JAX pool's ratings, games, win rates and
  promotions exactly (the same float arithmetic); the replay, a torn last
  line and each package's reading of the other's `league.jsonl` give the
  state back.
- `fit_elo`, `pairwise_win_fraction`, `elo_expected`: equal (NumPy on
  both sides).
- `Matchmaker`: the probabilities and the opponents drawn for a seed
  equal.
- `TrajectoryEmitter`: the harvest of served games under the exact stub
  nets equals the JAX emitter's: grids, policy targets, returns,
  versions and episode statistics exactly; the other features within
  2.5e-7 relative (the JAX package's mean is the sum times a float32
  reciprocal; the port copies it, the frameworks round the sum apart).
- The staleness guard's cases (`tests/test_league.py`), a member swap
  under int8 recasting, an unreadable member, and `cli league --device
  cpu` end to end from a `cli train` pool.

Two flywheel iterations against the JAX components are
`tests/test_torch_flywheel.py`.
"""

import json
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from alphatriangle_tpu import league as jleague  # noqa: E402
from alphatriangle_tpu.config import AlphaTriangleMCTSConfig as JaxMCTSConfig  # noqa: E402
from alphatriangle_tpu.config import LeagueConfig as JaxLeagueConfig  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.mcts import BatchedMCTS as JaxMCTS  # noqa: E402
from alphatriangle_tpu.serving import PolicyService as JaxService  # noqa: E402
from alphatriangle_tpu.telemetry import perf as jperf  # noqa: E402
from alphatriangle_tpu_torch import cli, league, rng  # noqa: E402
from alphatriangle_tpu_torch.config import LeagueConfig, PersistenceConfig, TrainConfig  # noqa: E402
from alphatriangle_tpu_torch.env import TriangleEnv  # noqa: E402
from alphatriangle_tpu_torch.features import FeatureExtractor  # noqa: E402
from alphatriangle_tpu_torch.league import emitter as emitter_mod  # noqa: E402
from alphatriangle_tpu_torch.league.flywheel import member_variables  # noqa: E402
from alphatriangle_tpu_torch.mcts import BatchedMCTS  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork, precision  # noqa: E402
from alphatriangle_tpu_torch.rl import Trainer  # noqa: E402
from alphatriangle_tpu_torch.rl.types import SelfPlayResult  # noqa: E402
from alphatriangle_tpu_torch.serving import PolicyService  # noqa: E402
from alphatriangle_tpu_torch.stats import CheckpointManager  # noqa: E402
from alphatriangle_tpu_torch.telemetry import ledger as tledger  # noqa: E402
from alphatriangle_tpu_torch.telemetry import perf as tperf  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    CPU,
    JaxExactStub,
    TorchExactStub,
    inject_jax_noise,
    small_model_config,
    torch_cfg,
    torch_key,
)

# --- config ------------------------------------------------------------------


def test_league_config_loads_jax_dump():
    for kw in ({}, {"LEAGUE_SLOTS": 16, "GAMES_PER_ROUND": 16, "STALENESS_WINDOW": None,
                    "LEAGUE_MIX_RATIO": 1.0, "PROMOTION_WIN_RATE": 0.0}):
        dump = JaxLeagueConfig(**kw).model_dump()
        assert LeagueConfig(**dump).model_dump() == dump


@pytest.mark.parametrize("bad", [
    {"GAMES_PER_ROUND": 9}, {"LEAGUE_SLOTS": 0}, {"LEAGUE_MIX_RATIO": 1.5},
    {"EXPLORATION_FLOOR": -0.1}, {"MATCH_TEMPERATURE": 0.0}, {"PROMOTION_MIN_GAMES": 0},
    {"PROMOTION_WIN_RATE": 1.1}, {"RELOAD_EVERY_STEPS": 0}, {"ELO_K": 0.0},
])
def test_league_config_bounds_match_jax(bad):
    with pytest.raises(ValueError):
        JaxLeagueConfig(**bad)
    with pytest.raises(ValueError):
        LeagueConfig(**bad)


# --- the pool ----------------------------------------------------------------


def _pool_state(pool) -> dict:
    return {
        "members": pool.members,
        "ratings": pool.ratings,
        "games": pool.games,
        "win_sum": pool.win_sum,
        "promotions": pool.promotions,
        "ids": pool.member_ids(),
        "win_rates": {m: pool.win_rate(m) for m in [*pool.members, league.LIVE_ID]},
    }


def _drive_pools(pools, seed: int = 0):
    """One event sequence on every pool: seed members, results from a
    NumPy generator, promotion attempts through the gate."""
    pick = np.random.default_rng(seed)
    for pool in pools:
        pool.add_member("src:step_00000002", "/ckpt/a", 2)
        pool.add_member("src:step_00000004", "/ckpt/b", 4)
        pool.add_member("src:step_00000002", "/ckpt/dup", 2)  # idempotent
    promoted = [[] for _ in pools]
    for step in range(1, 13):
        opponent = ["src:step_00000002", "src:step_00000004"][int(pick.integers(2))]
        score = float(pick.choice([0.0, 0.25, 0.5, 0.75, 1.0]))
        for i, pool in enumerate(pools):
            pool.record_result(league.LIVE_ID, opponent, score)
            promoted[i].append(pool.maybe_promote(f"/ckpt/live{step}", step, 3, 0.5))
    return promoted


def test_pool_matches_jax_and_replays(tmp_path):
    ours = league.LeaguePool(tmp_path / "ours" / "league.jsonl", elo_k=24.0)
    ref = jleague.LeaguePool(tmp_path / "ref" / "league.jsonl", elo_k=24.0)
    promoted_ours, promoted_ref = _drive_pools([ours, ref])
    assert promoted_ours == promoted_ref and ours.promotions == ref.promotions >= 1
    assert _pool_state(ours) == _pool_state(ref)
    # The files hold the same records (times aside), and replay the state.
    strip = [{k: v for k, v in r.items() if k != "time"} for r in league.pool.iter_jsonl_records(ours.path)]
    assert strip == [{k: v for k, v in r.items() if k != "time"}
                     for r in league.pool.iter_jsonl_records(ref.path)]
    replayed = league.LeaguePool(ours.path, elo_k=24.0)
    assert _pool_state(replayed) == _pool_state(ours)
    # A torn last line (a crash mid-append) is skipped by both readers.
    with ours.path.open("a") as f:
        f.write('{"kind": "result", "a": "live", "b": "src:st')
    with ref.path.open("a") as f:
        f.write('{"kind": "result", "a": "live", "b": "src:st')
    assert _pool_state(league.LeaguePool(ours.path, elo_k=24.0)) == _pool_state(
        jleague.LeaguePool(ref.path, elo_k=24.0)
    ) == _pool_state(ours)


def test_each_package_reads_the_others_league_file(tmp_path):
    ours = league.LeaguePool(tmp_path / "ours.jsonl", elo_k=32.0)
    ref = jleague.LeaguePool(tmp_path / "ref.jsonl", elo_k=32.0)
    _drive_pools([ours, ref], seed=4)
    assert _pool_state(league.LeaguePool(ref.path)) == _pool_state(ref)
    assert _pool_state(jleague.LeaguePool(ours.path)) == _pool_state(ours)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_elo_helpers_match_jax(seed):
    pick = np.random.default_rng(seed)
    a, b = pick.integers(0, 9, 7).astype(float), pick.integers(0, 9, 5).astype(float)
    for paired in (False, True):
        assert league.pairwise_win_fraction(a, b, paired) == jleague.pairwise_win_fraction(a, b, paired)
        assert league.pairwise_win_fraction(a, a[::-1], paired) == jleague.pairwise_win_fraction(
            a, a[::-1], paired
        )
    assert league.pairwise_win_fraction([], b) == jleague.pairwise_win_fraction([], b) == 0.5
    wins = np.clip(pick.random((4, 4)), 0.05, 0.95)
    np.testing.assert_array_equal(league.fit_elo(wins), jleague.fit_elo(wins))
    ra, rb = pick.normal(size=2) * 300
    assert league.elo_expected(ra, rb) == jleague.elo_expected(ra, rb)


@pytest.mark.parametrize("seed,floor,temperature", [(0, 0.1, 200.0), (7, 0.0, 50.0), (3, 1.0, 200.0)])
def test_matchmaker_matches_jax(tmp_path, seed, floor, temperature):
    ours = league.LeaguePool(tmp_path / "ours.jsonl")
    ref = jleague.LeaguePool(tmp_path / "ref.jsonl")
    _drive_pools([ours, ref], seed=seed)
    mo = league.Matchmaker(ours, temperature=temperature, exploration_floor=floor, seed=seed)
    mr = jleague.Matchmaker(ref, temperature=temperature, exploration_floor=floor, seed=seed)
    assert mo.probabilities() == mr.probabilities()
    assert mo.probabilities(123.0) == mr.probabilities(123.0)
    assert [mo.sample_opponent() for _ in range(40)] == [mr.sample_opponent() for _ in range(40)]
    assert mo.opponent_mix() == mr.opponent_mix()
    with pytest.raises(RuntimeError):
        league.Matchmaker(league.LeaguePool(tmp_path / "empty.jsonl")).sample_opponent()


# --- the emitter -------------------------------------------------------------


def test_emitter_harvest_matches_jax(monkeypatch, tiny_env_config, tiny_model_config):
    """Both services serve the same sessions under the exact stub nets
    with an emitter attached and a reload between dispatches; sessions
    close as their games end, the rest at the last dispatch. The drained
    harvests agree."""
    inject_jax_noise(monkeypatch)
    mcts_cfg = JaxMCTSConfig(max_simulations=4, max_depth=3, mcts_batch_size=4)
    jenv = JaxEnv(tiny_env_config)
    jfe = get_feature_extractor(jenv, tiny_model_config)
    tenv = TriangleEnv(torch_cfg(tiny_env_config), device=CPU)
    tfe = FeatureExtractor(tenv, torch_cfg(tiny_model_config))
    tnet = NeuralNetwork(torch_cfg(tiny_model_config), torch_cfg(tiny_env_config), device=CPU)
    adim, atoms = tiny_env_config.action_dim, tiny_model_config.NUM_VALUE_ATOMS
    jm = JaxMCTS(jenv, jfe, JaxExactStub(adim, atoms), mcts_cfg, jax.numpy.asarray(tnet.support.numpy()))
    tm = BatchedMCTS(tenv, tfe, TorchExactStub(adim, atoms), torch_cfg(mcts_cfg), tnet.support)
    from types import SimpleNamespace

    jsvc = JaxService(jenv, jfe, SimpleNamespace(variables={}, weights_version=0), jm, slots=4, rng_seed=2)
    tsvc = PolicyService(tenv, tfe, tnet, tm, slots=4, rng_seed=2)
    jem = jleague.TrajectoryEmitter(jenv, jfe, gamma=0.9)
    tem = league.TrajectoryEmitter(tenv, tfe, gamma=0.9)
    jsvc.emitter, tsvc.emitter = jem, tem
    keys = jax.random.split(jax.random.PRNGKey(8), 3)
    jsess, tsess = jsvc.open_sessions(keys), tsvc.open_sessions(torch_key(keys))
    for s in jsess:
        jsvc.request_move(s.sid)
    for s in tsess:
        tsvc.request_move(s.sid)
    for d in range(6):
        jres, tres = jsvc.dispatch(), tsvc.dispatch()
        assert [(r["sid"], r["action"]) for r in tres] == [(r["sid"], r["action"]) for r in jres]
        for svc, res in ((jsvc, jres), (tsvc, tres)):
            for r in res:
                if r["done"] or d == 5:
                    svc.close_session(r["sid"])
                else:
                    svc.request_move(r["sid"])
        if d == 2:
            jsvc.weight_reloads += 1  # the staleness tag moves
            tsvc.weight_reloads += 1
    want, got = jem.drain(), tem.drain()
    assert got.num_experiences == want.num_experiences > 0
    assert tem.moves_emitted == jem.moves_emitted and tem.episodes_emitted == jem.episodes_emitted == 3
    np.testing.assert_array_equal(got.grid, np.asarray(want.grid))
    np.testing.assert_allclose(got.other_features, np.asarray(want.other_features), rtol=2.5e-7, atol=0)
    np.testing.assert_array_equal(got.policy_target, np.asarray(want.policy_target))
    np.testing.assert_array_equal(got.value_target, np.asarray(want.value_target))
    np.testing.assert_array_equal(got.policy_weight, np.asarray(want.policy_weight))
    assert got.context == want.context and set(got.context["row_versions"]) == {0, 1}
    for field in ("episode_scores", "episode_lengths", "episode_start_versions", "num_episodes",
                  "num_truncated", "trainer_step_at_episode_start"):
        assert getattr(got, field) == getattr(want, field), field
    assert tem.drain() is None and jem.drain() is None


# --- the staleness guard (tests/test_league.py's cases) ----------------------


def _harvest(versions, n_actions=12):
    n = len(versions)
    return SelfPlayResult(
        grid=np.zeros((n, 1, 3, 4), np.float32),
        other_features=np.zeros((n, 5), np.float32),
        policy_target=np.full((n, n_actions), 1.0 / n_actions, np.float32),
        value_target=np.arange(n, dtype=np.float32),
        episode_scores=[1.0],
        episode_lengths=[n],
        episode_start_versions=[versions[0]],
        num_episodes=1,
        context={"source": "league", "row_versions": list(versions)},
    )


class TestStalenessGuard:
    def test_fresh_rows_pass_untouched(self):
        result = _harvest([5, 5, 6])
        kept, dropped = league.apply_staleness_guard(result, clock=6, window=2)
        assert kept is result and dropped == 0

    def test_stale_rows_drop_and_count(self, caplog, monkeypatch):
        monkeypatch.setattr(emitter_mod, "_stale_warned", False)
        result = _harvest([0, 1, 7, 8])
        with caplog.at_level(logging.WARNING):
            kept, dropped = league.apply_staleness_guard(result, clock=9, window=3)
        assert dropped == 2 and kept.num_experiences == 2
        assert kept.context["row_versions"] == [7, 8]
        np.testing.assert_array_equal(kept.value_target, [2.0, 3.0])
        assert any("Staleness guard" in r.message for r in caplog.records)
        caplog.clear()
        with caplog.at_level(logging.WARNING):  # warn-once
            league.apply_staleness_guard(_harvest([0]), clock=9, window=3)
        assert not any("Staleness guard" in r.message for r in caplog.records)

    def test_all_stale_returns_none(self):
        kept, dropped = league.apply_staleness_guard(_harvest([0, 0]), clock=10, window=1)
        assert kept is None and dropped == 2

    def test_window_off_and_none_passthrough(self):
        result = _harvest([0])
        assert league.apply_staleness_guard(result, 100, -1) == (result, 0)
        assert league.apply_staleness_guard(result, 100, None) == (result, 0)
        assert league.apply_staleness_guard(None, 100, 4) == (None, 0)

    def test_merge_carries_row_versions(self):
        merged = league.merge_results([_harvest([1, 2]), None, _harvest([4])])
        assert merged.context["row_versions"] == [1, 2, 4] and merged.num_episodes == 2
        assert league.merge_results([]) is None


# --- member weights -----------------------------------------------------------


def test_member_swap_recasts_int8(tmp_path, tiny_env_config):
    """An int8 service swaps to a pool member restored from its checkpoint:
    the cast copy is made afresh from the member's weights (the same
    quantization as casting the member's own net), and the learner that
    wrote the checkpoint is untouched by the restore."""
    env_cfg = torch_cfg(tiny_env_config)
    model_cfg = torch_cfg(small_model_config(tiny_env_config, INFERENCE_PRECISION="int8"))
    env = TriangleEnv(env_cfg, device=CPU)
    fe = FeatureExtractor(env, model_cfg)
    member_net = NeuralNetwork(model_cfg, env_cfg, seed=4, device=CPU)
    mgr = CheckpointManager(PersistenceConfig(ROOT_DATA_DIR=str(tmp_path), RUN_NAME="pool"))
    path = mgr.save(3, Trainer(member_net, TrainConfig(RUN_NAME="pool")).get_state())
    net = NeuralNetwork(model_cfg, env_cfg, seed=1, device=CPU)
    svc = PolicyService(env, fe, net, BatchedMCTS(env, fe, net.model, torch_cfg(
        JaxMCTSConfig(max_simulations=4, max_depth=3, mcts_batch_size=4)), net.support), slots=2)
    before = svc._serve_variables()
    assert before is svc._serve_variables()  # memoized
    state = member_variables(mgr, path, svc.net.model.state_dict())
    svc.reload_weights(state)
    after = svc._serve_variables()
    assert after is not before and after.precision == "int8"
    want = precision.InferenceNet(member_net.model, model_cfg)
    got_w, want_w = after.params.dequantize(), want.params.dequantize()
    assert got_w.keys() == want_w.keys()
    for name, w in want_w.items():
        assert torch.equal(got_w[name], w), name
    for got_t, want_t in zip(after.tensors(), want.tensors(), strict=True):
        assert torch.equal(got_t, want_t)  # the int8 q and scales themselves
    for name, p in member_net.model.state_dict().items():
        assert torch.equal(svc.net.model.state_dict()[name], p), name
    (s,) = svc.open_sessions(rng.split(rng.PRNGKey(3), 1))
    svc.request_move(s.sid)
    assert len(svc.dispatch()) == 1 and svc.mcts.model is after


def test_unreadable_member_raises_with_its_path(tmp_path):
    """A pool member the port cannot read (a JAX Orbax step directory has
    no `train_state.pt`) raises with its path; a missing one too."""
    mgr = CheckpointManager(PersistenceConfig(ROOT_DATA_DIR=str(tmp_path), RUN_NAME="pool"))
    orbax = tmp_path / "jax_run" / "checkpoints" / "step_00000004"
    (orbax / "default").mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    for path in (orbax, tmp_path / "gone" / "step_00000001"):
        with pytest.raises(FileNotFoundError, match=str(path)):
            member_variables(mgr, path, {})


def test_pruned_member_raises_with_its_path(tmp_path, tiny_env_config, tiny_model_config):
    """Pool members point into checkpoint directories that retention
    prunes (`KEEP_LAST_CHECKPOINTS`), as in the JAX package: once a
    member's step is pruned, restoring it raises with its path, while a
    member that retention kept still restores."""
    env_cfg, model_cfg = torch_cfg(tiny_env_config), torch_cfg(tiny_model_config)
    mgr = CheckpointManager(
        PersistenceConfig(ROOT_DATA_DIR=str(tmp_path), RUN_NAME="pool", KEEP_LAST_CHECKPOINTS=2)
    )
    net = NeuralNetwork(model_cfg, env_cfg, seed=4, device=CPU)
    state = Trainer(net, TrainConfig(RUN_NAME="pool")).get_state()
    paths = [mgr.save(step, state) for step in (1, 2, 3)]
    assert mgr.list_steps() == [2, 3] and not paths[0].exists()
    pool = league.LeaguePool(tmp_path / league.LEAGUE_FILENAME)
    for step, path in zip((1, 2, 3), paths, strict=True):
        pool.add_member(f"pool:step_{step:08d}", str(path), step)
    template = net.model.state_dict()
    kept = member_variables(mgr, pool.members["pool:step_00000003"]["checkpoint"], template)
    assert kept.keys() == template.keys()
    pruned = pool.members["pool:step_00000001"]["checkpoint"]
    with pytest.raises(FileNotFoundError, match=str(pruned)):
        member_variables(mgr, pruned, template)


# --- cli league -----------------------------------------------------------------


def _tiny_preset(tmp_path, env_cfg, model_cfg) -> str:
    path = tmp_path / "tiny_preset.json"
    path.write_text(json.dumps({
        "schema": "alphatriangle.tuned_preset.v1",
        "configs": {
            "env": env_cfg.model_dump(),
            "model": model_cfg.model_dump(),
            "train": TrainConfig().model_dump(),
            "mcts": JaxMCTSConfig(max_simulations=4, max_depth=3, mcts_batch_size=4).model_dump(),
        },
    }))
    return str(path)


def test_cli_league_end_to_end(tmp_path, tiny_env_config, tiny_model_config, capsys):
    """`cli train` writes a pool of two checkpoints; `cli league --device
    cpu` trains against it at mix 1.0 under a permissive gate: exit 0,
    every round ingests the live side's moves less the stale ones, the
    live net is promoted, and `league.jsonl` replays (in either package)
    to the ratings the report prints."""
    preset = _tiny_preset(tmp_path, tiny_env_config, tiny_model_config)
    root = str(tmp_path / "runs")
    common = ["--device", "cpu", "--root-dir", root, "--self-play-batch", "2", "--batch-size", "4",
              "--min-buffer", "4", "--buffer-capacity", "64", "--rollout-chunk", "4",
              "--checkpoint-freq", "2"]
    rc = cli.main(["train", "--preset", preset, "--run-name", "pool", "--max-steps", "4",
                   "--no-tensorboard", "--no-auto-resume", *common])
    assert rc == 0
    capsys.readouterr()
    rc = cli.main(["league", "--pool-from", "pool", "--run-name", "fly", "--steps", "4", "--mix", "1.0",
                   "--slots", "4", "--games", "2", "--max-moves", "8", "--sims", "4",
                   "--promotion-games", "1", "--promotion-win-rate", "0.0", *common])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == report["exit"] == 0 and report["status"] == "completed"
    assert report["pool_size"] >= 3 and report["promotions"] >= 1  # two seeds + a promotion
    assert {"pool:step_00000002", "pool:step_00000004"} <= set(report["ratings"])
    assert report["league_rounds"] >= 1 and report["steps"] == 4
    records = report["league_records"]
    assert len(records) == report["league_rounds"]
    for r in records:
        assert r["moves_ingested"] == r["live_moves"] - r["stale_dropped"]
    assert report["league_moves_ingested"] == report["league_live_moves"] - report["stale_dropped"] > 0
    # One `kind:"league"` ledger record per round, the report's records,
    # folded by the JAX `summarize_league` as by the port's.
    ledgered = [r for r in tledger.read_ledger(report["ledger"]) if r.get("kind") == "league"]
    assert ledgered == records
    assert tperf.summarize_league(ledgered) == jperf.summarize_league(ledgered)
    assert tperf.summarize_league(ledgered)["league_rounds"] == report["league_rounds"]
    for pool in (league.LeaguePool(report["league_jsonl"]), jleague.LeaguePool(report["league_jsonl"])):
        assert {m: round(pool.rating(m), 2) for m in pool.member_ids()} == report["ratings"]
        assert round(pool.rating(league.LIVE_ID), 2) == report["live_elo"]
