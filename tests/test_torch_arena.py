"""Arena play of the PyTorch port (`alphatriangle_tpu_torch/arena.py`),
its run-config reload (`config/run_configs.py`) and `cli eval`, against
the JAX package's `arena.py` and `tests/test_arena.py`.

- The port's own contracts: paired hands are deterministic at a fixed
  seed, the termination check interval changes nothing, arena play
  through `PolicyService` equals direct greedy play (every session
  retired), a policy reads the net's weights at every call.
- Against the JAX arena, exactly: under the exact stub nets of
  `torch_parity.py` and JAX's noise injected into the port, the port's
  `play_service` dispatches the JAX `play_service`'s moves (slot,
  action, reward, done and score of every served request) and ends
  with its scores, lengths and done flags; the uniform-random baseline
  (host NumPy draws over the engine's masks) gives the JAX baseline's
  scores.
- `cli eval` on the CPU against a port checkpoint prints the JAX
  report's keys, head to head included, and refuses Gumbel search.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from alphatriangle_tpu.arena import play as jax_play  # noqa: E402
from alphatriangle_tpu.arena import play_service as jax_play_service  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.mcts import BatchedMCTS as JaxMCTS  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.serving import PolicyService as JaxService  # noqa: E402
from alphatriangle_tpu_torch import cli  # noqa: E402
from alphatriangle_tpu_torch.arena import (  # noqa: E402
    TERMINATION_CHECK_EVERY,
    greedy_mcts_policy,
    play,
    play_service,
    random_policy,
)
from alphatriangle_tpu_torch.config.run_configs import (  # noqa: E402
    load_run_configs,
    load_run_configs_or_default,
)
from alphatriangle_tpu_torch.env import TriangleEnv  # noqa: E402
from alphatriangle_tpu_torch.features import FeatureExtractor  # noqa: E402
from alphatriangle_tpu_torch.mcts import BatchedMCTS  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork  # noqa: E402
from alphatriangle_tpu_torch.serving import PolicyService  # noqa: E402
from alphatriangle_tpu_torch.training import LoopStatus, run_training  # noqa: E402
from test_torch_resume import _cfg as run_cfg  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    CPU,
    JaxExactStub,
    TorchExactStub,
    inject_jax_noise,
    run_root,
    stub_net,
    torch_cfg,
)


@pytest.fixture
def arena_world(tiny_env_config, tiny_model_config, tiny_mcts_config):
    env = TriangleEnv(torch_cfg(tiny_env_config), device=CPU)
    fe = FeatureExtractor(env, torch_cfg(tiny_model_config))
    net = NeuralNetwork(torch_cfg(tiny_model_config), torch_cfg(tiny_env_config), seed=0, device=CPU)
    mcts = BatchedMCTS(env, fe, net.model, torch_cfg(tiny_mcts_config), net.support)
    return env, fe, net, mcts


class TestArenaPlay:
    def test_paired_hands_are_deterministic(self, arena_world):
        env, _, net, mcts = arena_world
        policy = greedy_mcts_policy(net, mcts)
        first = play(env, policy, games=4, max_moves=5, seed=3)
        again = play(env, policy, games=4, max_moves=5, seed=3)
        for a, b in zip(first, again):
            np.testing.assert_array_equal(a, b)
        assert first[0].shape == (4,) and TERMINATION_CHECK_EVERY == 8

    def test_termination_check_interval_preserves_paired_hands(self, arena_world):
        env, _, net, mcts = arena_world
        policy = greedy_mcts_policy(net, mcts)
        every_move = play(env, policy, games=4, max_moves=12, seed=5, termination_check_every=1)
        deferred = play(env, policy, games=4, max_moves=12, seed=5, termination_check_every=8)
        for a, b in zip(every_move, deferred):
            np.testing.assert_array_equal(a, b)

    def test_policy_reads_the_installed_weights(self, arena_world):
        env, _, net, mcts = arena_world
        policy = greedy_mcts_policy(net, mcts)
        before = play(env, policy, games=4, max_moves=5, seed=3)
        net.set_weights({k: v + 0.5 for k, v in net.get_weights().items()})
        after = play(env, policy, games=4, max_moves=5, seed=3)
        assert mcts.model is net.model
        assert not all(np.array_equal(a, b) for a, b in zip(before, after))

    def test_play_service_matches_direct_play(self, arena_world):
        env, fe, net, mcts = arena_world
        direct = play(env, greedy_mcts_policy(net, mcts), games=4, max_moves=10, seed=3)
        service = PolicyService(env, fe, net, mcts, slots=4)
        served = play_service(service, games=4, max_moves=10, seed=3)
        for a, b in zip(direct, served):
            np.testing.assert_array_equal(a, b)
        assert service.sessions.live_count == 0 and service.sessions.retired_total == 4
        with pytest.raises(RuntimeError, match="free slots"):
            play_service(PolicyService(env, fe, net, mcts, slots=2), games=4, max_moves=2, seed=0)


def _recording(service, results: list):
    real = service.dispatch

    def dispatch(**kw):
        out = real(**kw)
        results.append(
            [(r["slot"], r["move"], r["action"], r["reward"], r["done"], r["score"]) for r in out]
        )
        return out

    service.dispatch = dispatch


class TestAgainstJax:
    @pytest.mark.parametrize("max_moves", [3, 40])
    def test_play_service_matches_the_jax_arena(
        self, monkeypatch, max_moves, tiny_env_config, tiny_model_config, tiny_mcts_config
    ):
        """Under exact stub nets: at 3 moves the stragglers are closed at
        `max_moves`; at 40 every game ends on its own."""
        inject_jax_noise(monkeypatch)
        adim, atoms = tiny_env_config.action_dim, tiny_model_config.NUM_VALUE_ATOMS
        tenv = TriangleEnv(torch_cfg(tiny_env_config), device=CPU)
        tfe = FeatureExtractor(tenv, torch_cfg(tiny_model_config))
        tnet = NeuralNetwork(
            torch_cfg(tiny_model_config), torch_cfg(tiny_env_config), seed=0, device=CPU
        )
        tmodel = TorchExactStub(adim, atoms)
        tm = BatchedMCTS(tenv, tfe, tmodel, torch_cfg(tiny_mcts_config), tnet.support)
        tsvc = PolicyService(tenv, tfe, stub_net(tmodel, tnet.support), tm, slots=6)
        jenv = JaxEnv(tiny_env_config)
        jfe = get_feature_extractor(jenv, tiny_model_config)
        jnet = JaxNetwork(tiny_model_config, tiny_env_config, seed=0)
        jm = JaxMCTS(
            jenv, jfe, JaxExactStub(adim, atoms), tiny_mcts_config,
            jax.numpy.asarray(tnet.support.numpy()),
        )
        jsvc = JaxService(jenv, jfe, jnet, jm, slots=6)
        jsvc._programs[6] = jm.search  # the raw search, not a program cached across services
        got, want = [], []
        _recording(tsvc, got)
        _recording(jsvc, want)
        ours = play_service(tsvc, games=6, max_moves=max_moves, seed=4)
        theirs = jax_play_service(jsvc, games=6, max_moves=max_moves, seed=4)
        assert got == want and len(got) == min(max_moves, len(want)) > 0
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert tsvc.sessions.retired_total == jsvc.sessions.retired_total == 6
        if max_moves == 40:
            assert ours[2].all() and len(got) < max_moves
        else:
            assert (ours[1] == max_moves).any()

    def test_random_baseline_matches_the_jax_one(self, tiny_env_config):
        jenv = JaxEnv(tiny_env_config)
        tenv = TriangleEnv(torch_cfg(tiny_env_config), device=CPU)
        draws = np.random.default_rng(7)

        def jax_random(states, move):  # alphatriangle_tpu/cli.py:cmd_eval's baseline
            masks = np.asarray(jenv.valid_mask_batch(states))
            logits = np.where(masks, draws.random(masks.shape), -np.inf)
            return np.where(masks.any(axis=1), logits.argmax(axis=1), 0)

        theirs = jax_play(jenv, jax_random, 8, 60, 7)
        ours = play(tenv, random_policy(tenv, 7), 8, 60, 7)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert ours[2].any()


class TestRunConfigs:
    def test_roundtrip(self, tmp_path, tiny_env_config, tiny_model_config):
        env, model = torch_cfg(tiny_env_config), torch_cfg(tiny_model_config)
        (tmp_path / "configs.json").write_text(
            json.dumps({"env": env.model_dump(), "model": model.model_dump()})
        )
        loaded = load_run_configs(tmp_path)
        assert loaded["env"] == env and loaded["model"] == model
        assert load_run_configs_or_default(tmp_path) == (env, model)

    def test_missing_falls_back_to_defaults(self, tmp_path):
        assert load_run_configs(tmp_path) is None
        env, model = load_run_configs_or_default(tmp_path)
        assert (env.ROWS, env.COLS) == (8, 15) and model.OTHER_NN_INPUT_FEATURES_DIM > 0

    def test_corrupt_dump_falls_back(self, tmp_path):
        (tmp_path / "configs.json").write_text("{not json")
        assert load_run_configs(tmp_path) is None
        assert load_run_configs_or_default(tmp_path)[0].ROWS == 8


JAX_REPORT_KEYS = {
    "source", "games", "sims", "mcts_mean_score", "mcts_max_score", "mcts_mean_length",
    "finished_fraction", "random_mean_score", "score_vs_random", "paired_mean_diff",
    "paired_win_rate",
}
H2H_KEYS = {"vs_source", "vs_mean_score", "h2h_paired_mean_diff", "h2h_win_rate"}


def test_cli_eval_on_a_port_checkpoint(
    capsys, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
):
    configs = (torch_cfg(tiny_env_config), torch_cfg(tiny_model_config), torch_cfg(tiny_mcts_config))
    for run in ("a", "b"):
        loop = run_training(
            torch_cfg(run_cfg(run, 2, AUTO_RESUME_LATEST=False, RANDOM_SEED=5 + len(run))),
            *configs, persistence_config=run_root(tmp_path, run), device=CPU,
        )
        assert loop.status == LoopStatus.COMPLETED
    step_b = run_root(tmp_path, "b").get_checkpoint_dir() / "step_00000002"
    args = ["eval", "--device", "cpu", "--root-dir", str(tmp_path), "--games", "4", "--sims", "4",
            "--max-moves", "6", "--seed", "2"]
    assert cli.main([*args, "--run-name", "a", "--vs-checkpoint", str(step_b)]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert JAX_REPORT_KEYS | H2H_KEYS <= set(report)
    assert report["source"] == "a step 2" and report["vs_source"] == "step 2"
    assert report["games"] == 4 and 0.0 <= report["finished_fraction"] <= 1.0
    assert report["dispatches"] <= 6 and len(report["random_scores"]) == 4
    # The run's own board (configs.json): the random side on it, replayed.
    env = TriangleEnv(torch_cfg(tiny_env_config), device=CPU)
    r_scores, _, _ = play(env, random_policy(env, 2), 4, 6, 2)
    assert report["random_scores"] == r_scores.tolist()
    assert cli.main([*args, "--checkpoint", str(step_b)]) == 0
    alone = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert alone["source"] == "step 2" and not H2H_KEYS & set(alone)
    assert alone["random_scores"] == report["random_scores"]  # the same hands
    # --gumbel: the Gumbel search in exploit mode plays its own selections.
    assert cli.main([*args, "--run-name", "a", "--gumbel"]) == 0
    gumbel = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert gumbel["gumbel"] and not report["gumbel"] and gumbel["source"] == "a step 2"
    assert JAX_REPORT_KEYS <= set(gumbel) and gumbel["random_scores"] == report["random_scores"]
    assert gumbel["dispatches"] <= 6 and np.isfinite(gumbel["mcts_scores"]).all()
