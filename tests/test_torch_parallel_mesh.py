"""The port's three-axis mesh (`config/mesh_config.py`,
`parallel/distributed.py` `attach_groups`, `training/setup.py`) and the
synchronous loop over mdl and sp ranks.

- The rank -> (dp, mdl, sp) index layout against the JAX `build_mesh`
  device grid (`np.asarray(devices).reshape(dp, MDL, SP)`), on meshes
  of 8.
- Lanes at (dp=2, mdl=2, sp=2) against
  `tests/test_multichip_selfplay.py:96-109`: the JAX lanes shard over
  (dp, sp), 4 ways, each shard replicated over mdl; every rank's lanes
  are the JAX shard of its device.
- `run_training` on two gloo ranks (`tests/torch_dp_rank.py`, no JAX)
  at (mdl=2) and at (sp=2, ring), 2 iterations of the synchronous loop:
  COMPLETED, the gathered digests equal after every iteration, the mdl
  line's first rank alone playing (its replica receives the harvest),
  the first iteration's ring rows bit-equal to the one-rank run's, and the
  checkpoint's lane totals equal to the one-rank run's (each lane
  counted once). Self-play keeps the first weights
  (WORKER_UPDATE_FREQ_STEPS above the run), so both runs play the same
  games.
- A TP pair's checkpoint resumes in one process, and a one-process
  checkpoint in a TP pair: the state written again at the resumed step
  is the checkpoint's, bit for bit.
- The megastep and DEVICE_REPLAY="on" under an mdl or sp axis raise,
  with JAX's reason (a dp-only mesh).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from alphatriangle_tpu.config import MeshConfig as JaxMeshConfig  # noqa: E402
from alphatriangle_tpu_torch import config as tcfg  # noqa: E402
from alphatriangle_tpu_torch.config import MeshConfig  # noqa: E402
from alphatriangle_tpu_torch.config.mesh_config import Mesh  # noqa: E402
from alphatriangle_tpu_torch.rl.buffer import ExperienceBuffer  # noqa: E402
from alphatriangle_tpu_torch.telemetry.device_stats import reset_device_stats_state  # noqa: E402
from alphatriangle_tpu_torch.training import runner  # noqa: E402
from alphatriangle_tpu_torch.training.setup import make_buffer, rank_lanes  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import collect_ranks, small_model_config, spawn_ranks, torch_cfg  # noqa: E402

SHAPES = [(8, 1, 1), (4, 2, 1), (4, 1, 2), (2, 2, 2), (1, 2, 4), (1, 8, 1)]


@pytest.fixture(autouse=True)
def _device_stats_defaults():
    """A training setup in this process turns the process-wide device
    stat-packs on; later test files in the worker expect the defaults."""
    yield
    reset_device_stats_state()


@pytest.mark.parametrize("dp, mdl, sp", SHAPES)
def test_rank_layout_matches_jax_device_grid(dp, mdl, sp):
    devices = jax.devices()[:8]
    grid = JaxMeshConfig(DP_SIZE=dp, MDL_SIZE=mdl, SP_SIZE=sp).build_mesh(devices).devices
    for (i, j, k), dev in np.ndenumerate(grid):
        mesh = MeshConfig(DP_SIZE=dp, MDL_SIZE=mdl, SP_SIZE=sp).build_mesh(8, devices.index(dev))
        assert (mesh.dp_index, mesh.mdl_index, mesh.sp_index) == (i, j, k)
        assert mesh.shape == {"dp": dp, "mdl": mdl, "sp": sp} and mesh.rank == devices.index(dev)


def test_lanes_ride_dp_and_sp_replicated_over_mdl():
    devices = jax.devices()[:8]
    jmesh = JaxMeshConfig(DP_SIZE=2, MDL_SIZE=2, SP_SIZE=2).build_mesh(devices)
    lanes = 8
    # The engine's lane sharding for data_axes ("dp", "sp").
    where = NamedSharding(jmesh, P(("dp", "sp"))).devices_indices_map((lanes,))
    assert len(where) == 8
    for dev, (rows,) in where.items():
        mesh = MeshConfig(DP_SIZE=2, MDL_SIZE=2, SP_SIZE=2).build_mesh(8, devices.index(dev))
        mine = rank_lanes(mesh, lanes)
        assert (mine.lo, mine.hi, mine.total) == (rows.start, rows.stop, lanes)
    assert rank_lanes(Mesh(dp=1, mdl=2), lanes) is None


def _spec(tmp_path, env_cfg, model_cfg, mcts_cfg, train: dict, run: str, mesh: dict) -> dict:
    return {
        "scenario": "train", "mesh": mesh,
        "env": env_cfg.model_dump(), "model": model_cfg.model_dump(), "mcts": mcts_cfg.model_dump(),
        "train": train, "persistence": {"ROOT_DATA_DIR": str(tmp_path / "runs"), "RUN_NAME": run},
    }


def _train(run: str, **kw) -> dict:
    return tcfg.TrainConfig(
        RUN_NAME=run, AUTO_RESUME_LATEST=False, SELF_PLAY_BATCH_SIZE=4, BATCH_SIZE=8,
        MIN_BUFFER_SIZE_TO_TRAIN=4, BUFFER_CAPACITY=64, ROLLOUT_CHUNK_MOVES=4, N_STEP_RETURNS=2,
        LEARNER_STEPS_PER_ROLLOUT=1, MAX_TRAINING_STEPS=2, WORKER_UPDATE_FREQ_STEPS=1000,
        RANDOM_SEED=5, **kw,
    ).model_dump()


def _one_process(tmp_path, env_cfg, model_cfg, mcts_cfg, train: dict, run: str, monkeypatch):
    adds = []
    add_dense = ExperienceBuffer.add_dense

    def recording(self, *args, **kwargs):
        adds.append([np.array(a) for a in args] + [np.array(v) for v in kwargs.values()])
        return add_dense(self, *args, **kwargs)

    monkeypatch.setattr(ExperienceBuffer, "add_dense", recording)
    loop = runner.run_training(
        train_config=tcfg.TrainConfig(**train), env_config=env_cfg, model_config=model_cfg,
        mcts_config=mcts_cfg,
        persistence_config=tcfg.PersistenceConfig(ROOT_DATA_DIR=str(tmp_path / "runs"), RUN_NAME=run),
        device="cpu",
    )
    monkeypatch.setattr(ExperienceBuffer, "add_dense", add_dense)
    return loop.report(), adds


def _run_dir(tmp_path, run: str):
    return tmp_path / "runs" / "AlphaTriangleTPUTorch" / "runs" / run


def _checkpoint(tmp_path, run: str, step: int) -> tuple:
    base = _run_dir(tmp_path, run) / "checkpoints"
    state = torch.load(base / f"step_{step:08d}" / "train_state.pt", weights_only=False)
    return state, json.loads((base / f"step_{step:08d}.meta.json").read_text())


def _assert_states_equal(a: dict, b: dict) -> None:
    for part in ("params", "batch_stats"):
        assert set(a[part]) == set(b[part]), part
        for name, t in a[part].items():
            assert torch.equal(t, b[part][name]), (part, name)
    for part in ("mu", "nu"):
        for name, t in a["opt_state"][part].items():
            assert torch.equal(t, b["opt_state"][part][name]), (part, name)
    assert (a["step"], a["opt_state"]["count"]) == (b["step"], b["opt_state"]["count"])
    assert torch.equal(a["rng"], b["rng"])


def test_run_training_over_mdl_and_sp_ranks(tmp_path, tiny_env_config, tiny_mcts_config, monkeypatch):
    env_cfg, mcts_cfg = torch_cfg(tiny_env_config), torch_cfg(tiny_mcts_config)
    model_cfg = torch_cfg(small_model_config(tiny_env_config))
    meshes = {"tp": {"MDL_SIZE": 2}, "sp": {"SP_SIZE": 2, "SP_ATTENTION": "ring"}}
    runs = {}
    for name, mesh in meshes.items():
        (tmp_path / name).mkdir()
        runs[name] = spawn_ranks(
            _spec(tmp_path, env_cfg, model_cfg, mcts_cfg, _train(name), name, mesh), tmp_path / name
        )
    one, one_adds = _one_process(tmp_path, env_cfg, model_cfg, mcts_cfg, _train("one"), "one", monkeypatch)
    assert one["status"] == "completed" and one["steps"] == 2
    one_state, one_meta = _checkpoint(tmp_path, "one", 2)
    results = {name: collect_ranks(*runs[name]) for name in meshes}
    for name, ranks in results.items():
        reports = [r["report"] for r in ranks]
        for r, rep in enumerate(reports):
            assert rep["status"] == "completed", (name, rep["error"])
            assert rep["steps"] == one["steps"] and rep["iterations"] == one["iterations"], name
            assert rep["dp"]["world"] == 2 and rep["dp"]["rank"] == r
            assert rep["replay_ring"] == "host" and rep["buffer_size"] == one["buffer_size"], name
            # The first ingest: the one-rank run's rows, in its order.
            first = ranks[r]["first_add"]
            assert len(first) == len(one_adds[0])
            for got, want in zip(first, one_adds[0]):
                np.testing.assert_array_equal(got, want, err_msg=name)
        # The mdl line's first rank plays; its replica receives the rows.
        played = [r["chunks"] for r in ranks]
        assert played == ([one["iterations"], 0] if name == "tp" else [one["iterations"]] * 2), name
        digests = [rep["dp"]["param_checksums"] for rep in reports]
        assert len(digests[0]) == one["iterations"] and digests[0] == digests[1], name
        _, meta = _checkpoint(tmp_path, name, 2)
        for key in ("episodes_played", "total_simulations"):
            assert meta[key] == one_meta[key], (name, key, meta[key], one_meta[key])
    assert [r["report"]["dp"]["index"] for r in results["tp"]] == [
        {"dp": 0, "mdl": 0, "sp": 0}, {"dp": 0, "mdl": 1, "sp": 0}]
    assert [r["report"]["dp"]["index"]["sp"] for r in results["sp"]] == [0, 1]

    # The TP pair's checkpoint (whole tensors) in one process: the state
    # written again at the resumed step is the checkpoint's.
    tp_state, _ = _checkpoint(tmp_path, "tp", 2)
    resumed, _ = _one_process(tmp_path, env_cfg, model_cfg, mcts_cfg, _train("tp"), "tp", monkeypatch)
    assert resumed["resumed_step"] == 2 and resumed["status"] == "completed"
    _assert_states_equal(_checkpoint(tmp_path, "tp", 2)[0], tp_state)

    # The one-process checkpoint in a TP pair, likewise (rank 0 writes
    # the gathered state).
    (tmp_path / "back").mkdir()
    ranks = collect_ranks(*spawn_ranks(
        _spec(tmp_path, env_cfg, model_cfg, mcts_cfg, _train("one"), "one", {"MDL_SIZE": 2}),
        tmp_path / "back",
    ))
    assert [r["report"]["resumed_step"] for r in ranks] == [2, 2]
    _assert_states_equal(_checkpoint(tmp_path, "one", 2)[0], one_state)


@pytest.mark.parametrize("axis", ["mdl", "sp"])
@pytest.mark.parametrize("what", ["megastep", "on"])
def test_device_rings_refused_under_mdl_and_sp(tiny_env_config, axis, what):
    env_cfg = torch_cfg(tiny_env_config)
    model_cfg = torch_cfg(small_model_config(tiny_env_config))
    train = tcfg.TrainConfig(FUSED_MEGASTEP=what == "megastep", DEVICE_REPLAY="on" if what == "on" else "auto",
                             SELF_PLAY_BATCH_SIZE=4, BATCH_SIZE=8, BUFFER_CAPACITY=64,
                             MIN_BUFFER_SIZE_TO_TRAIN=8)
    mesh = Mesh(**{axis: 2})
    extractor = type("X", (), {"other_dim": model_cfg.OTHER_NN_INPUT_FEATURES_DIM})()
    with pytest.raises(ValueError, match="dp-only mesh"):
        make_buffer(train, env_cfg, model_cfg, extractor, torch.device("cpu"), mesh)
