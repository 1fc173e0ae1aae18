"""Parity of the port's dp megastep (`rl/megastep.py` over the sharded
ring, `rl/sharded_device_buffer.py`) with the JAX dp = 2 megastep
(`megastep/dp2_t2_k2`, JAX `rl/megastep.py::_sharded_impl`).

Both sides start from the same converted net and seeds, stripe the
same 24 warm-up rows over two ring shards, seed their priorities from
the same TD errors and run one megastep of 2 moves and 2 learner steps:
JAX on a dp = 2 mesh of the suite's virtual CPU devices, the port as two
gloo ranks (`tests/torch_dp_rank.py`, no JAX), each with its 2 of the
4 lanes and its shard. The search runs without root or wave noise and
plays greedily (the port's Gumbel and gamma draws are not JAX's, and a
rank imports no JAX to borrow them), so the chunk is a function of the
net and the engine's threefry streams, which are JAX's bit for bit.

Exact: each shard's counters and the rows it ingested (grid, policy
target and weight; the n-step returns within 1e-5 and the scalar
features within one ulp, as `test_torch_megastep.py` holds the
one-device ring), and the PER indices, drawn on each shard with the key
folded with its index. The IS weights, max-normalised over the global
batch, within 1e-6 of the JAX draw's (recomputed from JAX's indices and
priorities); the parameters within rtol 2e-4, atol 2e-5 (apart from the
rounding-sized entries, `torch_parity.rounding_sized`), and bit for bit
equal on the two ranks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from alphatriangle_tpu.config import MeshConfig as JaxMeshConfig  # noqa: E402
from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.rl.megastep import MegastepRunner as JaxRunner  # noqa: E402
from alphatriangle_tpu.rl.self_play import SelfPlayEngine as JaxEngine  # noqa: E402
from alphatriangle_tpu.rl.sharded_device_buffer import (  # noqa: E402
    ShardedDeviceReplayBuffer as JaxShardedRing,
)
from alphatriangle_tpu.rl.trainer import Trainer as JaxTrainer  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    assert_params_within,
    collect_ranks,
    converted_state_dict,
    dense_rows,
    jax_adam_moments,
    rounding_sized,
    spawn_ranks,
    torch_cfg,
)

DP, MOVES, K = 2, 2, 2
SUM_ATOL = 1e-5


def _train_cfg() -> JaxTrainConfig:
    return JaxTrainConfig(
        RUN_NAME="mega_dp_parity", AUTO_RESUME_LATEST=False, MAX_TRAINING_STEPS=8,
        SELF_PLAY_BATCH_SIZE=4, ROLLOUT_CHUNK_MOVES=MOVES, BATCH_SIZE=8, BUFFER_CAPACITY=64,
        MIN_BUFFER_SIZE_TO_TRAIN=16, USE_PER=True, PER_BETA_ANNEAL_STEPS=8, N_STEP_RETURNS=1,
        MAX_EPISODE_MOVES=30, RANDOM_SEED=5, FUSED_MEGASTEP=True, DEVICE_REPLAY="on",
        FUSED_LEARNER_STEPS=K, TEMPERATURE_INITIAL=0.0, TEMPERATURE_FINAL=0.0,
    )


def test_dp_megastep_matches_jax_dp2(tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config):
    jtc = _train_cfg()
    mcts = tiny_mcts_config.model_copy(
        update={"dirichlet_epsilon": 0.0, "wave_noise_scale": 0.0, "max_simulations": 4, "max_depth": 3}
    )
    env = JaxEnv(tiny_env_config)
    extractor = get_feature_extractor(env, tiny_model_config)
    jnet = JaxNetwork(tiny_model_config, tiny_env_config, seed=jtc.RANDOM_SEED)
    torch.save(converted_state_dict(jnet), tmp_path / "net.pt")
    rows = dense_rows(3, 24, (1, tiny_env_config.ROWS, tiny_env_config.COLS), extractor.other_dim,
                      tiny_env_config.action_dim)
    td = np.random.default_rng(4).uniform(0.05, 3.0, 24)
    np.savez(tmp_path / "rows.npz", td=td, **rows)
    procs, out = spawn_ranks(
        {
            "scenario": "megastep",
            "env": tiny_env_config.model_dump(),
            "model": tiny_model_config.model_dump(),
            "train": torch_cfg(jtc).model_dump(),
            "mcts": mcts.model_dump(),
            "state_dict": str(tmp_path / "net.pt"),
            "rows": str(tmp_path / "rows.npz"),
            "moves": MOVES,
            "k": K,
        },
        tmp_path,
    )

    mesh = JaxMeshConfig(DP_SIZE=DP).build_mesh(jax.devices()[:DP])
    trainer = JaxTrainer(jnet, jtc, mesh=mesh)
    ring = JaxShardedRing(jtc, grid_shape=(1, tiny_env_config.ROWS, tiny_env_config.COLS),
                          other_dim=extractor.other_dim, action_dim=tiny_env_config.action_dim,
                          mesh=mesh, dp_axis="dp")
    engine = JaxEngine(env, extractor, jnet, mcts, jtc, seed=jtc.RANDOM_SEED + 1, mesh=mesh,
                       data_axes=("dp",))
    runner = JaxRunner(engine, trainer, ring, jtc)
    slots = ring.add_dense(**rows)
    ring.update_priorities(slots, td)
    runner.sync_priorities_from_host()
    pre = np.asarray(runner._priorities).copy()
    cursors = ring._cursors.copy()
    watermark = runner._max_priority_watermark()
    outs = []
    fn = runner._megastep_fn

    def recording(t, k):
        program = fn(t, k)

        def run(*args):
            result = program(*args)
            outs.append(jax.device_get(result[-1]))
            return result

        return run

    runner._megastep_fn = recording
    runner.run_megastep(MOVES, K)
    ranks = collect_ranks(procs, out)

    jout = outs[0]
    counts = np.asarray(jout["counts"]).reshape(-1)
    assert counts.sum() > 0
    host = jax.device_get(ring.storage)
    b_local = jtc.BATCH_SIZE // DP
    beta = np.float32(jtc.PER_BETA_INITIAL)
    # The IS weights the JAX draw implies: each shard's pre-draw
    # priorities (the seeded mirror, fresh rows at the global watermark),
    # its size, one max over the global batch per step.
    raw = []
    for r, got in enumerate(ranks):
        lo = r * ring.stride
        assert (got["pos"], got["size"]) == (int(ring._cursors[r]), int(ring._sizes[r]))
        assert got["count"] == counts[r]
        assert got["watermark"] == pytest.approx(watermark)
        np.testing.assert_array_equal(got["global_idx"], np.asarray(jout["idx"])[:, r * b_local:(r + 1) * b_local])
        for name, col in host.items():
            want, have = col[lo: lo + ring.cap_local], got["storage"][name].numpy()
            if name == "value_target":
                np.testing.assert_allclose(have, want, atol=SUM_ATOL, err_msg=name)
            elif name == "other_features":
                np.testing.assert_allclose(have, want, rtol=2.5e-7, atol=0, err_msg=name)
            else:
                np.testing.assert_array_equal(have, want, err_msg=name)
        p = pre[lo: lo + ring.cap_local].astype(np.float64)
        fresh = (int(cursors[r]) + np.arange(counts[r])) % ring.cap_local
        p[fresh] = np.float32(watermark)
        probs = p[got["idx"]] / p.sum()
        raw.append((got["size"] * probs) ** -np.float64(beta))
    top = np.maximum(raw[0].max(axis=1), raw[1].max(axis=1))[:, None]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["weights"], raw[r] / top, atol=1e-6, rtol=1e-6)

    r0, r1 = ranks
    assert r0["checksum"] == r1["checksum"]
    for name, t in r0["state"].items():
        assert torch.equal(t, r1["state"][name]), name
    rounding = rounding_sized(jax_adam_moments(trainer.state.opt_state)[1])
    assert_params_within(r0["state"], trainer.state.params, rounding, jtc.LEARNING_RATE, K)
