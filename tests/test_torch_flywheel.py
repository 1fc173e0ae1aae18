"""Two flywheel iterations (`league/flywheel.py`) at mix 1.0 against the
JAX package's components driven in `FlywheelLoop._process_rollout`'s order, in
the style of `tests/test_torch_sync_loop.py::test_iterations_match_jax`.

Each iteration is a league round (the live net's games harvested by the
emitter, a matchmade opponent's games, the Elo update, the promotion
gate, the staleness guard, the ring ingest) followed by the learner
steps the rows call for. The conftest's tiny net outputs its output
biases whatever its inputs, so both frameworks' searches see exactly
the same priors and values; the first round leaves the ring short of
MIN_BUFFER_SIZE_TO_TRAIN, so both rounds play the weights of step 0.

Exact: the rows each round ingests (the other features within 2.5e-7
relative, the value targets within 1e-6: float sums in another order),
the buffer length, the opponents drawn, the ratings, the promotions and
the stale rows. Within `tests/test_torch_learner.py`'s tolerance: the
losses (1e-4 relative). One opponent is a pool member the port restores
from its own checkpoint (`CheckpointManager.restore_path`), whose
weights the JAX side reads from the same converted net; the other is
the live net promoted in the first round.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from alphatriangle_tpu import league as jleague  # noqa: E402
from alphatriangle_tpu.arena import play_service as jax_play_service  # noqa: E402
from alphatriangle_tpu.config import LeagueConfig as JaxLeagueConfig  # noqa: E402
from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.mcts import BatchedMCTS as JaxMCTS  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.rl.buffer import ExperienceBuffer as JaxBuffer  # noqa: E402
from alphatriangle_tpu.rl.trainer import Trainer as JaxTrainer  # noqa: E402
from alphatriangle_tpu.serving import PolicyService as JaxService  # noqa: E402
from alphatriangle_tpu_torch import league  # noqa: E402
from alphatriangle_tpu_torch.config import PersistenceConfig, TrainConfig  # noqa: E402
from alphatriangle_tpu_torch.league.flywheel import FlywheelLoop  # noqa: E402
from alphatriangle_tpu_torch.mcts import BatchedMCTS  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork  # noqa: E402
from alphatriangle_tpu_torch.ops import KERNELS  # noqa: E402
from alphatriangle_tpu_torch.rl import Trainer  # noqa: E402
from alphatriangle_tpu_torch.serving import PolicyService  # noqa: E402
from alphatriangle_tpu_torch.stats import CheckpointManager  # noqa: E402
from alphatriangle_tpu_torch.training import setup_training_components  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    CPU,
    converted_state_dict,
    inject_jax_noise,
    run_root,
    torch_cfg,
)

LOSS_RTOL = 1e-4
SEED_MEMBER = "pool:step_00000001"


def _configs():
    jtc = JaxTrainConfig(
        RUN_NAME="fly", AUTO_RESUME_LATEST=False, MAX_TRAINING_STEPS=8, SELF_PLAY_BATCH_SIZE=4,
        ROLLOUT_CHUNK_MOVES=4, BATCH_SIZE=2, BUFFER_CAPACITY=2000, MIN_BUFFER_SIZE_TO_TRAIN=12,
        USE_PER=True, PER_BETA_ANNEAL_STEPS=8, N_STEP_RETURNS=2, WORKER_UPDATE_FREQ_STEPS=2,
        CHECKPOINT_SAVE_FREQ_STEPS=100, MAX_EPISODE_MOVES=30, RANDOM_SEED=5,
    )
    jlc = JaxLeagueConfig(
        LEAGUE_SLOTS=4, GAMES_PER_ROUND=2, MAX_GAME_MOVES=8, LEAGUE_MIX_RATIO=1.0,
        RELOAD_EVERY_STEPS=1, STALENESS_WINDOW=4, PROMOTION_MIN_GAMES=1, PROMOTION_WIN_RATE=0.0,
    )
    return jtc, jlc


def test_flywheel_iterations_match_jax(
    monkeypatch, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
):
    inject_jax_noise(monkeypatch)
    jtc, jlc = _configs()
    seed = jtc.RANDOM_SEED

    # --- JAX components -------------------------------------------------
    env = JaxEnv(tiny_env_config)
    fe = get_feature_extractor(env, tiny_model_config)
    jnet = JaxNetwork(tiny_model_config, tiny_env_config, seed=seed)
    jtrainer = JaxTrainer(jnet, jtc)
    jbuf = JaxBuffer(jtc, action_dim=tiny_env_config.action_dim)
    jserve_net = JaxNetwork(tiny_model_config, tiny_env_config, seed=seed + 7)
    jsvc = JaxService(
        env, fe, jserve_net,
        JaxMCTS(env, fe, jserve_net.model, tiny_mcts_config, jserve_net.support),
        slots=jlc.LEAGUE_SLOTS, rng_seed=seed + 11,
    )
    jem = jleague.TrajectoryEmitter(env, fe, use_gumbel=False, gamma=jtc.GAMMA)
    jpool = jleague.LeaguePool(tmp_path / "jax" / "league.jsonl", elo_k=jlc.ELO_K)
    jmm = jleague.Matchmaker(jpool, jlc.MATCH_TEMPERATURE, jlc.EXPLORATION_FLOOR, seed=seed)
    member_net = JaxNetwork(tiny_model_config, tiny_env_config, seed=99)
    jmembers = {SEED_MEMBER: member_net.variables}

    # --- the port --------------------------------------------------------
    env_cfg, model_cfg = torch_cfg(tiny_env_config), torch_cfg(tiny_model_config)
    c = setup_training_components(
        torch_cfg(jtc), env_cfg, model_cfg, torch_cfg(tiny_mcts_config),
        persistence_config=run_root(tmp_path), device=CPU,
    )
    state = converted_state_dict(jnet)
    c.net.model.load_state_dict(state)
    c.trainer.model.load_state_dict(state)
    # The seed member: the same converted weights, in a checkpoint of the port's.
    pool_mgr = CheckpointManager(PersistenceConfig(ROOT_DATA_DIR=str(tmp_path), RUN_NAME="pool"))
    member_path = pool_mgr.save(1, Trainer(
        NeuralNetwork(model_cfg, env_cfg, state_dict=converted_state_dict(member_net), device=CPU),
        TrainConfig(RUN_NAME="pool"),
    ).get_state())
    serve_net = NeuralNetwork(model_cfg, env_cfg, seed=seed + 7, device=CPU)
    service = PolicyService(
        c.env, c.extractor, serve_net,
        BatchedMCTS(c.env, c.extractor, serve_net.model, c.mcts_config, serve_net.support),
        slots=jlc.LEAGUE_SLOTS, rng_seed=seed + 11,
    )
    pool = league.LeaguePool(tmp_path / "port" / "league.jsonl", elo_k=jlc.ELO_K)
    for p, path in ((pool, str(member_path)), (jpool, str(member_path))):
        p.add_member(SEED_MEMBER, path, 1)
    loop = FlywheelLoop(
        c, torch_cfg(jlc), service, league.TrajectoryEmitter(c.env, c.extractor, gamma=jtc.GAMMA),
        pool, league.Matchmaker(pool, jlc.MATCH_TEMPERATURE, jlc.EXPLORATION_FLOOR, seed=seed),
    )
    before = {name: kern.launches for name, kern in KERNELS.items()}

    jsteps = jsyncs = jdropped = 0
    jlive, jlive_step = None, None
    for it in range(2):
        # --- JAX, in FlywheelLoop._process_rollout / _league_round's order -------
        if jlive is None or jsteps - jlive_step >= jlc.RELOAD_EVERY_STEPS:
            jlive = jax.tree_util.tree_map(jax.numpy.array, jtrainer.get_variables())
            jlive_step = jsteps
        round_seed = seed + 9001 + 2 * it
        jsvc.reload_weights(jlive)
        jsvc.emitter = jem
        live_scores, _, _ = jax_play_service(jsvc, jlc.GAMES_PER_ROUND, jlc.MAX_GAME_MOVES, round_seed)
        jsvc.emitter = None
        opponent = jmm.sample_opponent()
        jsvc.reload_weights(jmembers[opponent])
        opp_scores, _, _ = jax_play_service(jsvc, jlc.GAMES_PER_ROUND, jlc.MAX_GAME_MOVES, round_seed + 1)
        jpool.record_result(jleague.LIVE_ID, opponent, jleague.pairwise_win_fraction(live_scores, opp_scores))
        promoted = jpool.maybe_promote(
            str(c.persistence_config.get_checkpoint_dir().resolve() / f"step_{jsteps:08d}"),
            jsteps, jlc.PROMOTION_MIN_GAMES, jlc.PROMOTION_WIN_RATE,
        )
        if promoted is not None:
            jmembers[promoted] = jax.tree_util.tree_map(jax.numpy.array, jtrainer.get_variables())
        harvest, dropped = jleague.apply_staleness_guard(
            jem.drain(), jsvc.weight_reloads, jlc.STALENESS_WINDOW
        )
        jdropped += dropped
        jbuf.add_dense(
            harvest.grid, harvest.other_features, harvest.policy_target, harvest.value_target,
            policy_weight=harvest.policy_weight,
        )
        jadded = harvest.num_experiences
        want_results = []
        for _ in range(max(1, round(jadded / jtc.BATCH_SIZE))):
            s = jbuf.sample(jtc.BATCH_SIZE, current_train_step=jtrainer.global_step)
            if s is None:
                break
            metrics, td = jtrainer.train_step(s["batch"])
            jbuf.update_priorities(s["indices"], td)
            jsteps += 1
            if jsteps % jtc.WORKER_UPDATE_FREQ_STEPS == 0:
                jtrainer.sync_to_network()
                jsyncs += 1
            want_results.append(metrics)

        # --- the port's flywheel: one iteration's pieces ---------------------
        added = loop._league_round()
        ran = loop._run_training_steps(max(1, round(added / jtc.BATCH_SIZE)))

        assert added == jadded > 0 and len(c.buffer) == len(jbuf)
        assert ran == len(want_results) and (ran == 0) == (it == 0)
        assert loop.round_records[-1]["opponent"] == opponent
        assert loop.round_records[-1]["promoted"] == promoted
        for name, col in jbuf._storage.items():
            got, want = c.buffer._storage[name][: len(jbuf)], col[: len(jbuf)]
            if name == "value_target":
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            elif name == "other_features":
                np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
        for m, jm in zip(loop.metrics[len(loop.metrics) - ran:], want_results, strict=True):
            for key, ref in jm.items():
                np.testing.assert_allclose(m[key], ref, rtol=LOSS_RTOL, err_msg=key)
        assert pool.ratings == jpool.ratings and pool.games == jpool.games
        assert pool.promotions == jpool.promotions and sorted(pool.members) == sorted(jpool.members)

    assert {name: kern.launches for name, kern in KERNELS.items()} == before  # CPU
    assert loop.league_rounds == 2 and loop.stale_dropped_total == jdropped
    assert loop.global_step == jsteps > 0 and loop.weight_updates == jsyncs
    assert service.weight_reloads == jsvc.weight_reloads == 4
    assert pool.promotions >= 1 and len(pool) == len(jpool) >= 2
    assert loop.league_moves_ingested == len(jbuf)
