"""The overlapped loop (`ASYNC_ROLLOUTS`) on a mesh with an mdl or sp axis
(`run_training(mesh_config=MeshConfig(MDL_SIZE=2))`, `SP_SIZE=2`): two
gloo ranks (`tests/torch_dp_rank.py` scenario `async_mesh`, no JAX)
against a one-rank overlapped run of the port and the JAX overlapped
run on a two-device CPU mesh of the same shape, all on the conftest's
tiny net (its transformer-free learner keeps the two JAX compiles to a
few seconds; the card's mesh phases run the default transformer).

The first rank of the (mdl, sp) block plays the dp row's whole lanes in
its two producer streams; the loop's main thread broadcasts each beat's
harvests over the block, and every rank folds them in that order. So:

- both ranks complete at MAX_TRAINING_STEPS in the same beats, with the
  same losses, and their gathered-parameter digests agree after every
  beat that trained;
- both rings hold the same harvests in the same order, row for row, and
  the same rows at the end: a harvest the block never received is
  dropped on every rank;
- the second rank plays nothing: no chunk, no stream;
- stream by stream, the harvests are the one-rank run's bit for bit and
  the JAX run's within the frameworks' rounding (`_assert_harvest`).
  Weights never sync during the runs (WORKER_UPDATE_FREQ_STEPS above
  them) and the search draws no noise, so each stream's chunks are fixed
  by its seed whatever the threads' timing; the harvests before the
  first learner step are among those compared.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu.config import AlphaTriangleMCTSConfig as JaxMCTSConfig  # noqa: E402
from alphatriangle_tpu.config import MeshConfig as JaxMeshConfig  # noqa: E402
from alphatriangle_tpu.config import PersistenceConfig as JaxPersistence  # noqa: E402
from alphatriangle_tpu.config import TelemetryConfig  # noqa: E402
from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.training.loop import LoopStatus as JaxStatus  # noqa: E402
from alphatriangle_tpu.training.loop import TrainingLoop as JaxLoop  # noqa: E402
from alphatriangle_tpu.training.setup import setup_training_components as jax_setup  # noqa: E402
from alphatriangle_tpu_torch import config as tcfg  # noqa: E402
from alphatriangle_tpu_torch.training import runner, setup  # noqa: E402
from alphatriangle_tpu_torch.training.loop import TrainingLoop  # noqa: E402
from torch_dp_rank import harvest_rows  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    collect_ranks,
    converted_state_dict,
    spawn_ranks,
    torch_cfg,
)

NET_ATOL = 1e-5  # returns and visit policies of the real net, as the JAX loop tests hold them
ULP_RTOL = 2.5e-7  # one float32 ulp: XLA's rewrite of a feature's divisions
STEPS = 3
MESHES = {"tp": {"MDL_SIZE": 2}, "sp": {"SP_SIZE": 2, "SP_ATTENTION": "ring"}}


def _configs(tiny_mcts_config, run: str) -> tuple:
    train = JaxTrainConfig(
        RUN_NAME=run, AUTO_RESUME_LATEST=False, SELF_PLAY_BATCH_SIZE=4, BATCH_SIZE=8,
        MIN_BUFFER_SIZE_TO_TRAIN=8, BUFFER_CAPACITY=64, ROLLOUT_CHUNK_MOVES=3, N_STEP_RETURNS=2,
        MAX_TRAINING_STEPS=STEPS, WORKER_UPDATE_FREQ_STEPS=1000, CHECKPOINT_SAVE_FREQ_STEPS=1000,
        RANDOM_SEED=5, ASYNC_ROLLOUTS=True, NUM_SELF_PLAY_WORKERS=2, ASYNC_CHUNK_SECONDS=None,
        REPLAY_RATIO=0.5, FUSED_LEARNER_STEPS=1, MAX_EPISODE_MOVES=30,
        TEMPERATURE_INITIAL=0.0, TEMPERATURE_FINAL=0.0,
    )
    mcts = JaxMCTSConfig(**{
        **tiny_mcts_config.model_dump(), "dirichlet_epsilon": 0.0, "wave_noise_scale": 0.0,
        "max_simulations": 4, "max_depth": 3,
    })
    return train, mcts


def _by_stream(folds: list) -> dict:
    out: dict = {}
    for f in folds:
        out.setdefault(int(f["stream"]), []).append(f)
    return out


def _assert_harvest(got: dict, want: dict, exact: bool) -> None:
    for name in ("grid", "policy_weight"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    if exact:
        for name in ("other_features", "policy_target", "value_target"):
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert got["episode_scores"] == want["episode_scores"]
    else:
        np.testing.assert_allclose(got["other_features"], want["other_features"], rtol=ULP_RTOL, atol=0)
        for name in ("policy_target", "value_target"):
            np.testing.assert_allclose(got[name], want[name], atol=NET_ATOL, err_msg=name)
        np.testing.assert_allclose(got["episode_scores"], want["episode_scores"], atol=NET_ATOL)
    assert (got["num_episodes"], got["episode_lengths"]) == (want["num_episodes"], want["episode_lengths"])


def _assert_streams(got: list, want: list, exact: bool, label: str) -> int:
    """Stream by stream, `got`'s harvests against `want`'s as far as both
    have them; returns how many were compared (each stream at least one)."""
    got, want = _by_stream(got), _by_stream(want)
    assert set(got) == set(want) == {0, 1}, label
    compared = 0
    for stream in got:
        n = min(len(got[stream]), len(want[stream]))
        assert n >= 1, (label, stream)
        for i in range(n):
            _assert_harvest(got[stream][i], want[stream][i], exact)
        compared += n
    return compared


def _one_rank(tmp_path, train, env_cfg, model_cfg, mcts, state) -> tuple:
    folds = []
    fold = TrainingLoop._fold_result

    def recording(self, result, trace=None, payload=None, ready=None, stream=None, added=None):
        folds.append({"stream": stream, "step": self.global_step, **harvest_rows(result)})
        return fold(self, result, trace, payload, ready, stream, added)

    build = setup.NeuralNetwork

    def loaded(*args, **kwargs):
        net = build(*args, **kwargs)
        net.model.load_state_dict(state)
        return net

    TrainingLoop._fold_result, setup.NeuralNetwork = recording, loaded
    try:
        loop = runner.run_training(
            train_config=torch_cfg(train), env_config=env_cfg, model_config=model_cfg, mcts_config=mcts,
            persistence_config=tcfg.PersistenceConfig(ROOT_DATA_DIR=str(tmp_path / "runs"), RUN_NAME="one"),
            device="cpu",
        )
    finally:
        TrainingLoop._fold_result, setup.NeuralNetwork = fold, build
    return loop.report(), folds


def _jax_loop(tmp_path, train, env_cfg, model_cfg, mcts, mesh: dict, name: str) -> tuple:
    """The JAX overlapped loop on a two-device CPU mesh, every fold recorded
    with the stream that played it (by the engine each harvest came from);
    (loop, its net, the folds)."""
    jc = jax_setup(
        train_config=train, env_config=env_cfg, model_config=model_cfg, mcts_config=mcts,
        mesh_config=JaxMeshConfig(DP_SIZE=1, **mesh),
        persistence_config=JaxPersistence(ROOT_DATA_DIR=str(tmp_path / "jax"), RUN_NAME=name),
        telemetry_config=TelemetryConfig(ENABLED=False), use_tensorboard=False,
    )
    loop = JaxLoop(jc)
    engines, played, folds = [], {}, []
    make, play, fold = loop._make_rollout_streams, loop._play_rollout, loop._fold_result

    def streams():
        engines.extend(make())
        return engines

    def playing(engine, moves):
        result, payload = play(engine, moves)
        played[id(result)] = engine
        return result, payload

    def recording(result, *args, **kwargs):
        stream = next(i for i, e in enumerate(engines) if e is played[id(result)])
        folds.append({"stream": stream, "step": loop.global_step, **harvest_rows(result)})
        return fold(result, *args, **kwargs)

    loop._make_rollout_streams, loop._play_rollout, loop._fold_result = streams, playing, recording
    return loop, jc.net, folds


def _jax_run(loop) -> None:
    assert loop.run() == JaxStatus.COMPLETED and loop.global_step == STEPS
    loop.c.stats.close()


def test_overlapped_loop_on_mdl_and_sp_meshes(tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config):
    train, mcts = _configs(tiny_mcts_config, "async_mesh")
    model = tiny_model_config
    env_cfg, model_cfg, mcts_cfg = torch_cfg(tiny_env_config), torch_cfg(model), torch_cfg(mcts)
    jax_runs = {name: _jax_loop(tmp_path, train, tiny_env_config, model, mcts, mesh, name)
                for name, mesh in MESHES.items()}
    state = converted_state_dict(jax_runs["tp"][1])
    for key, t in converted_state_dict(jax_runs["sp"][1]).items():
        assert torch.equal(t, state[key]), key  # one seed, one net
    torch.save(state, tmp_path / "net.pt")
    runs = {}
    for name, mesh in MESHES.items():
        (tmp_path / name).mkdir()
        spec = {
            "scenario": "async_mesh", "mesh": mesh, "state_dict": str(tmp_path / "net.pt"),
            "env": env_cfg.model_dump(), "model": model_cfg.model_dump(), "mcts": mcts_cfg.model_dump(),
            "train": torch_cfg(train).model_dump(),
            "persistence": {"ROOT_DATA_DIR": str(tmp_path / name / "runs"), "RUN_NAME": name},
        }
        runs[name] = spawn_ranks(spec, tmp_path / name)
    try:
        for loop, _, _ in jax_runs.values():
            _jax_run(loop)
        one, one_folds = _one_rank(tmp_path, train, env_cfg, model_cfg, mcts_cfg, state)
        results = {name: collect_ranks(*runs[name]) for name in MESHES}
    finally:  # a failure leaves no rank process behind, the other mesh's included
        for procs, _ in runs.values():
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    assert one["status"] == "completed" and one["steps"] == STEPS

    for name in MESHES:
        ranks = results[name]
        reports = [r["report"] for r in ranks]
        for r, rep in enumerate(reports):
            assert (rep["status"], rep["mode"], rep["steps"]) == ("completed", "async", STEPS), (name, rep["error"])
            assert rep["dp"]["world"] == 2 and rep["dp"]["rank"] == r and rep["replay_ring"] == "host"
        r0, r1 = reports
        assert r0["iterations"] == r1["iterations"] and r0["losses"] == r1["losses"], name
        digests = r0["dp"]["param_checksums"]
        assert digests and digests == r1["dp"]["param_checksums"], name
        # The block's first rank plays in both streams; its peer plays nothing.
        assert set(r0["harvests_by_stream"]) == {0, 1} and r1["harvests_by_stream"] == {}, name
        assert ranks[0]["chunks"] > 0 and ranks[1]["chunks"] == 0 and r1["chunk_moves"] == 0, name
        # Both rings hold the same harvests in the same order, and the same
        # rows at the end.
        f0, f1 = ranks[0]["folds"], ranks[1]["folds"]
        assert len(f0) == len(f1) == sum(r0["harvests_by_stream"].values()), name
        assert all(f["stream"] is None for f in f1), name
        for a, b in zip(f0, f1):
            assert a["step"] == b["step"]
            _assert_harvest(a, b, exact=True)
        assert (r0["rows_ingested"], r0["buffer_size"]) == (r1["rows_ingested"], r1["buffer_size"]), name
        assert any(f["step"] == 0 for f in f0), name
        # Stream by stream: the one-rank run's harvests, and the JAX run's.
        assert _assert_streams(f0, one_folds, exact=True, label=f"{name} / one rank") >= 2
        assert _assert_streams(f0, jax_runs[name][2], exact=False, label=f"{name} / JAX") >= 2
