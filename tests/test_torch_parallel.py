"""The port's data-parallel plumbing in one process: `parallel/`,
`config/mesh_config.py`, the sharded ring's shards
(`rl/sharded_device_buffer.py`) and the lane-sharded engine
(`rl/self_play.py`), against the JAX package where it has a
counterpart.

- `DistributedConfig` and `initialize_distributed` outside a group, as
  JAX `tests/test_distributed.py:30-46` holds its own; the backend rule
  and the refusals: MDL_SIZE > 1, SP_SIZE > 1, `--distributed
  --async-rollouts` (all naming ROADMAP.md item 6b), NCCL on the CPU and
  ranks that share a card without naming gloo.
- The sharded ring's cases of JAX `tests/test_sharded_device_buffer.py`
  at dp = 2: the port's two shards (built side by side; without a
  process group a shard's collectives are the identity) against the JAX
  ring's two shards, bit for bit: striped adds, ragged adds, invalid
  rows sent to the trash row, and snapshots across ring kinds (JAX
  sharded, host, the port's one-device ring).
- Lane sharding: two engines with lanes [0, 2) and [2, 4) of 4 play a
  chunk whose rows equal the unsharded JAX engine's rows of those lanes
  bit for bit (exact stub nets, JAX's Gumbel and gamma draws; n-step
  returns within 1e-5, scalar features within one ulp, as
  `test_torch_self_play.py` holds the unsharded engine). A rank's
  lane draws (`rng`'s `lanes=`) are the global draw's rows bit for bit,
  and JAX's for the counter-based draws.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alphatriangle_tpu.config import AlphaTriangleMCTSConfig  # noqa: E402
from alphatriangle_tpu.config import MeshConfig as JaxMeshConfig  # noqa: E402
from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.parallel.distributed import DistributedConfig as JaxDistributedConfig  # noqa: E402
from alphatriangle_tpu.rl import ExperienceBuffer as JaxHostRing  # noqa: E402
from alphatriangle_tpu.rl.self_play import SelfPlayEngine as JaxEngine  # noqa: E402
from alphatriangle_tpu.rl.sharded_device_buffer import (  # noqa: E402
    ShardedDeviceReplayBuffer as JaxShardedRing,
)
from alphatriangle_tpu_torch.config import MeshConfig  # noqa: E402
from alphatriangle_tpu_torch.config.mesh_config import Mesh, lane_shard_count, rollout_lane_axes  # noqa: E402
from alphatriangle_tpu_torch.env import TriangleEnv  # noqa: E402
from alphatriangle_tpu_torch.features import FeatureExtractor  # noqa: E402
from alphatriangle_tpu_torch.nn.model import value_support  # noqa: E402
from alphatriangle_tpu_torch.nn.network import LiveWeights  # noqa: E402
from alphatriangle_tpu_torch.parallel import (  # noqa: E402
    DistributedConfig,
    batch_rows,
    initialize_distributed,
    is_primary,
    local_rows,
    process_info,
    shard_batch,
    state_shardings,
)
from alphatriangle_tpu_torch.parallel.distributed import check_card_sharing, resolve_backend  # noqa: E402
from alphatriangle_tpu_torch.rl import ExperienceBuffer, SelfPlayEngine  # noqa: E402
from alphatriangle_tpu_torch.rl.device_buffer import DeviceReplayBuffer  # noqa: E402
from alphatriangle_tpu_torch.rl.sharded_device_buffer import ShardedDeviceReplayBuffer  # noqa: E402
from alphatriangle_tpu_torch import rng  # noqa: E402
from alphatriangle_tpu_torch.rng import Lanes  # noqa: E402
from alphatriangle_tpu_torch.training import setup_training_components  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    CPU,
    JaxExactStub,
    TorchExactStub,
    dense_rows,
    inject_jax_noise,
    jax_key,
    run_root,
    small_model_config,
    stub_net,
    torch_cfg,
)

DP = 2
ITEM_6E = "ROADMAP.md item 6e"


# --- membership, meshes and refusals -------------------------------------


class TestDistributedConfig:
    def test_explicit_fields_must_come_together(self):
        for cls in (DistributedConfig, JaxDistributedConfig):
            with pytest.raises(ValueError, match="together"):
                cls(ENABLED=True, COORDINATOR_ADDRESS="x:1")
            cfg = cls(ENABLED=True, COORDINATOR_ADDRESS="x:1", NUM_PROCESSES=2, PROCESS_ID=0)
            assert cfg.NUM_PROCESSES == 2
        with pytest.raises(ValueError, match="BACKEND"):
            DistributedConfig(BACKEND="mpi")

    def test_disabled_is_noop_single_process(self):
        assert initialize_distributed(None) is False
        assert initialize_distributed(DistributedConfig()) is False
        assert is_primary()
        assert process_info() == (0, 1)

    def test_backend_rule_and_card_sharing(self, monkeypatch):
        assert resolve_backend("auto", torch.device("cpu")) == "gloo"
        assert resolve_backend("auto", torch.device("cuda", 0)) == "nccl"
        assert resolve_backend("gloo", torch.device("cuda", 0)) == "gloo"
        with pytest.raises(ValueError, match="NCCL"):
            resolve_backend("nccl", torch.device("cpu"))
        cards = ["h:cuda:0", "h:cuda:0"]
        check_card_sharing("gloo", cards)
        check_card_sharing("nccl", ["h:cuda:0", "h:cuda:1", None, None])
        with pytest.raises(ValueError, match="share the card"):
            check_card_sharing("nccl", cards)

    def test_ranks_sharing_a_card_raise_before_the_group(self, tmp_path, monkeypatch):
        """Two ranks asking for one card under "auto" (NCCL) both raise at
        the rendezvous, before any group exists."""
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.delenv("LOCAL_RANK", raising=False)
        errors = {}

        def rank(r):
            cfg = DistributedConfig(ENABLED=True, COORDINATOR_ADDRESS=f"file://{tmp_path}/store",
                                    NUM_PROCESSES=2, PROCESS_ID=r, TIMEOUT_S=30)
            try:
                initialize_distributed(cfg, device="cuda")
            except ValueError as exc:
                errors[r] = str(exc)

        threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert set(errors) == {0, 1} and all("gloo" in e for e in errors.values())
        assert not torch.distributed.is_initialized()


class TestMesh:
    def test_build_mesh_over_the_ranks(self):
        mesh = MeshConfig().build_mesh(4, 2, "gloo")
        assert (mesh.dp, mesh.dp_index, mesh.shape) == (4, 2, {"dp": 4, "mdl": 1, "sp": 1})
        assert rollout_lane_axes(mesh) == ("dp",) and lane_shard_count(mesh, ("dp",)) == 4
        assert MeshConfig.single_device_mesh().dp == 1
        with pytest.raises(ValueError, match="one rank per device"):
            MeshConfig(DP_SIZE=2).build_mesh(4, 0)

    @pytest.mark.parametrize("case", ["MDL_SIZE", "SP_SIZE", "leaves_ranks_out"])
    def test_remaining_refusals(self, tmp_path, tiny_env_config, case):
        """An mdl or sp axis the world cannot hold raises, naming the
        ranks it needs, before setup makes a directory (one process is a
        world of one); a mesh that leaves ranks out of the world raises."""
        if case == "leaves_ranks_out":
            with pytest.raises(ValueError, match=r"Mesh of 2 ranks \(dp=1 x mdl=2 x sp=1\) over 4 ranks"):
                MeshConfig(DP_SIZE=1, MDL_SIZE=2).build_mesh(4, 0)
            return
        with pytest.raises(ValueError, match="needs 2 ranks"):
            MeshConfig(**{case: 2}).build_mesh(1, 0)
        with pytest.raises(ValueError, match="needs 2 ranks"):
            setup_training_components(
                env_config=torch_cfg(tiny_env_config), persistence_config=run_root(tmp_path),
                device=CPU, mesh_config=MeshConfig(**{case: 2}),
            )
        assert not (tmp_path / "AlphaTriangleTPUTorch").exists()

    def test_distributed_async_rollouts_refused(self, tmp_path, tiny_env_config):
        """The overlapped loop runs on a dp-only mesh (`cli train
        --distributed --async-rollouts`, tests/test_torch_async_dp.py);
        on a mesh with an mdl or sp axis it raises, naming its ROADMAP.md
        item, before the mesh is built or a directory made."""
        for axis in ("MDL_SIZE", "SP_SIZE"):
            with pytest.raises(ValueError, match=ITEM_6E):
                setup_training_components(
                    torch_cfg(JaxTrainConfig(ASYNC_ROLLOUTS=True, RUN_NAME="refused")),
                    env_config=torch_cfg(tiny_env_config), persistence_config=run_root(tmp_path),
                    device=CPU, mesh_config=MeshConfig(**{axis: 2}),
                )
        assert not (tmp_path / "AlphaTriangleTPUTorch").exists()

    def test_batch_rows_and_state_shardings(self):
        mesh = Mesh(dp=2, dp_index=1)
        batch = {"x": np.arange(8), "y": torch.arange(16).reshape(8, 2)}
        local = shard_batch(mesh, batch)
        np.testing.assert_array_equal(local["x"], [4, 5, 6, 7])
        assert local["y"].shape == (4, 2) and batch_rows(8, mesh) == slice(4, 8)
        np.testing.assert_array_equal(local_rows(np.arange(12).reshape(2, 6), mesh, axis=1),
                                      [[3, 4, 5], [9, 10, 11]])
        with pytest.raises(ValueError, match="divide"):
            batch_rows(7, mesh)
        assert set(state_shardings({"a": 1, "b": 2}, mesh).values()) == {"replicated"}


# --- the sharded ring's shards against the JAX ring's ----------------------


def _ring_cfg(**kw) -> JaxTrainConfig:
    base = dict(BATCH_SIZE=8, BUFFER_CAPACITY=16 * DP, MIN_BUFFER_SIZE_TO_TRAIN=4, USE_PER=True,
                PER_BETA_ANNEAL_STEPS=10, N_STEP_RETURNS=2, SELF_PLAY_BATCH_SIZE=DP,
                MAX_TRAINING_STEPS=100, RUN_NAME="sharded_ring")
    base.update(kw)
    return JaxTrainConfig(**base)


@pytest.fixture(scope="module")
def ring_world(tiny_env_config, tiny_model_config):
    env = JaxEnv(tiny_env_config)
    other = get_feature_extractor(env, tiny_model_config).other_dim
    mesh = JaxMeshConfig(DP_SIZE=DP).build_mesh(jax.devices()[:DP])
    return SimpleNamespace(grid=(1, env.rows, env.cols), other=other, adim=env.action_dim, mesh=mesh)


def _rings(w, tc):
    jring = JaxShardedRing(tc, grid_shape=w.grid, other_dim=w.other, action_dim=w.adim, mesh=w.mesh,
                           dp_axis="dp")
    shards = [
        ShardedDeviceReplayBuffer(torch_cfg(tc), grid_shape=w.grid, other_dim=w.other,
                                  action_dim=w.adim, device=CPU, mesh=Mesh(dp=DP, dp_index=r))
        for r in range(DP)
    ]
    return jring, shards


def _rows(w, n, seed, **kw):
    return dense_rows(seed, n, w.grid, w.other, w.adim, **kw)


def _assert_shards(jring, shards):
    """Each port shard's counters, rows (trash row aside) and priorities
    equal the JAX ring's shard."""
    host = jax.device_get(jring.storage)
    for r, shard in enumerate(shards):
        assert (shard._pos, len(shard)) == (int(jring._cursors[r]), int(jring._sizes[r])), r
        lo = r * jring.stride
        for name, col in host.items():
            np.testing.assert_array_equal(
                shard.storage[name][: shard.cap_local].numpy(), col[lo: lo + jring.cap_local],
                err_msg=f"shard {r} {name}",
            )
        leaves = np.arange(shard.cap_local)
        np.testing.assert_array_equal(shard.tree.tree[leaves + shard.tree._cap2],
                                      jring.trees[r].tree[leaves + jring.trees[r]._cap2])


def _global_snapshot(shards) -> dict:
    """What `get_state` gathers on rank 0: every shard's part, in order."""
    parts = [p for p in (s.local_part() for s in shards) if p is not None]
    size = sum(len(p["storage"]["value_target"]) for p in parts)
    return {
        "pos": size, "size": size,
        "storage": {k: np.concatenate([p["storage"][k] for p in parts]) for k in parts[0]["storage"]},
        "priorities": np.concatenate([p["priorities"] for p in parts]),
    }


def _case_stripes(w):
    jring, shards = _rings(w, _ring_cfg())
    rows = _rows(w, 4 * DP, seed=0)
    jslots = jring.add_dense(**rows)
    got = np.concatenate([s.global_indices(s.add_dense(**rows)) for s in shards])
    np.testing.assert_array_equal(got, jslots)
    return jring, shards


def _case_ragged(w):
    jring, shards = _rings(w, _ring_cfg())
    for seed, n in ((1, DP + 3), (2, 3), (3, 1)):
        rows = _rows(w, n, seed=seed)
        jring.add_dense(**rows)
        for s in shards:
            s.add_dense(**rows)
    return jring, shards


def _case_trash(w):
    jring, shards = _rings(w, _ring_cfg())
    rows = _rows(w, 4 * DP, seed=4, nonfinite=True, not_a_policy=True)
    jring.add_dense(**rows)
    for s in shards:
        s.add_dense(**rows)
    assert sum(len(s) for s in shards) == 4 * DP - 3
    return jring, shards


def _case_wrap_and_priorities(w):
    jring, shards = _rings(w, _ring_cfg())
    for seed in range(3):  # 3 x 12 rows wrap the 16-slot shards
        rows = _rows(w, 12, seed=10 + seed)
        jslots = jring.add_dense(**rows)
        td = np.random.default_rng(seed).uniform(0.1, 4.0, 12)
        jring.update_priorities(jslots, td)
        for s in shards:
            stripe = s._stripe(12)
            s.update_priorities(s.add_dense(**rows), td[stripe])
    return jring, shards


def _case_snapshot_from_jax_sharded(w):
    jring, _ = _case_wrap_and_priorities(w)
    snap = jring.get_state()
    fresh, shards = _rings(w, _ring_cfg())
    fresh.set_state(snap)
    for s in shards:
        s.set_state(snap)
    got = _global_snapshot(shards)
    for name, col in snap["storage"].items():
        np.testing.assert_array_equal(got["storage"][name], col, err_msg=name)
    np.testing.assert_array_equal(got["priorities"], snap["priorities"])
    return fresh, shards


def _case_snapshot_from_host(w):
    tc = _ring_cfg(BUFFER_CAPACITY=24)
    host, jhost = ExperienceBuffer(torch_cfg(tc), action_dim=w.adim), JaxHostRing(tc, action_dim=w.adim)
    for seed in range(2):  # 2 x 14 rows wrap the 24-slot host ring
        rows = _rows(w, 14, seed=20 + seed)
        host.add_dense(**rows)
        jhost.add_dense(**rows)
    jring, shards = _rings(w, _ring_cfg())
    jring.set_state(jhost.get_state())
    for s in shards:
        s.set_state(host.get_state())
    return jring, shards


RING_CASES = {
    "stripes": _case_stripes,
    "ragged": _case_ragged,
    "trash": _case_trash,
    "wrap_and_priorities": _case_wrap_and_priorities,
    "snapshot_from_jax_sharded": _case_snapshot_from_jax_sharded,
    "snapshot_from_host": _case_snapshot_from_host,
}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_shards_match_jax_sharded_ring(ring_world, case):
    _assert_shards(*RING_CASES[case](ring_world))


def test_sharded_snapshot_restores_into_one_device_ring(ring_world):
    _, shards = _case_wrap_and_priorities(ring_world)
    snap = _global_snapshot(shards)
    w = ring_world
    ring = DeviceReplayBuffer(torch_cfg(_ring_cfg()), w.grid, w.other, w.adim, CPU)
    ring.set_state(snap)
    assert len(ring) == snap["size"]
    for name, col in snap["storage"].items():
        np.testing.assert_array_equal(ring.storage[name][: len(ring)].numpy(), col, err_msg=name)
    np.testing.assert_array_equal(ring.get_state()["priorities"], snap["priorities"])


def test_shard_geometry_and_refusals(ring_world):
    w = ring_world
    _, shards = _rings(w, _ring_cfg())
    assert [(s.cap_local, s.stride, s.rank) for s in shards] == [(16, 17, 0), (16, 17, 1)]
    with pytest.raises(ValueError, match="divide"):
        ShardedDeviceReplayBuffer(torch_cfg(_ring_cfg(BUFFER_CAPACITY=33)), w.grid, w.other, w.adim,
                                  CPU, mesh=Mesh(dp=DP, dp_index=0))
    with pytest.raises(ValueError, match="divide"):
        shards[0].sample(7, current_train_step=0)


# --- lane sharding ---------------------------------------------------------


def test_rank_lanes_equal_unsharded_jax_engine_rows(monkeypatch, tiny_env_config):
    inject_jax_noise(monkeypatch)
    model_cfg = small_model_config(tiny_env_config)
    mcts_cfg = AlphaTriangleMCTSConfig(max_simulations=8, max_depth=4, mcts_batch_size=4)
    jcfg = JaxTrainConfig(AUTO_RESUME_LATEST=False, RUN_NAME="lanes", N_STEP_RETURNS=2,
                          MAX_EPISODE_MOVES=4, TEMPERATURE_ANNEAL_MOVES=4, SELF_PLAY_BATCH_SIZE=4)
    adim, atoms = tiny_env_config.action_dim, model_cfg.NUM_VALUE_ATOMS
    support = value_support(torch_cfg(model_cfg))
    jenv = JaxEnv(tiny_env_config)
    jnet = SimpleNamespace(model=JaxExactStub(adim, atoms), support=jnp.asarray(support.numpy()),
                           weights_version=3, variables={})
    jeng = JaxEngine(jenv, get_feature_extractor(jenv, model_cfg), jnet, mcts_cfg, jcfg, seed=9)
    moves = 6
    _, jout = jeng._chunk_fn(moves)({}, jeng._carry, jnp.int32(11))
    jout = jax.device_get(jout)
    assert jout["episode"]["ending"].any()  # resets ran inside the chunk
    tenv = TriangleEnv(torch_cfg(tiny_env_config), device=CPU)
    sentinels = 0
    for lo in (0, 2):
        teng = SelfPlayEngine(
            tenv, FeatureExtractor(tenv, torch_cfg(model_cfg)), stub_net(TorchExactStub(adim, atoms), support),
            torch_cfg(mcts_cfg), torch_cfg(jcfg), seed=9, lanes=Lanes(lo, lo + 2, 4),
        )
        assert teng.batch_size == 2
        _, tout = teng._chunk(moves, teng._carry, LiveWeights(11, teng.net.model))
        sentinels += tout.pop("sentinel_live").numpy()
        for part in ("mat", "flush", "episode", "trace"):
            for name, got in tout[part].items():
                if name in ("sims", "is_full"):
                    continue
                want = np.asarray(jout[part][name])[:, lo: lo + 2]
                got = got.numpy()
                if name in ("ret", "root_value"):
                    np.testing.assert_allclose(got, want, atol=1e-5, err_msg=f"{part}/{name}")
                elif name == "other":
                    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0, err_msg=f"{part}/{name}")
                else:
                    np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f"{part}/{name}")
    np.testing.assert_array_equal(sentinels, np.asarray(jout["sentinel_live"]))


# (port draw over `shape`, JAX's draw or None where the port's is not JAX's bits)
LANE_DRAWS = {
    "split": (lambda key, shape, lanes: rng.split(key, shape[0], lanes=lanes),
              lambda key, shape: jax.random.split(key, shape[0])),
    "bits": (lambda key, shape, lanes: rng.bits(key, shape, lanes=lanes),
             lambda key, shape: jax.random.bits(key, shape)),
    "uniform": (lambda key, shape, lanes: rng.uniform(key, shape, lanes=lanes),
                lambda key, shape: jax.random.uniform(key, shape)),
    "gumbel": (lambda key, shape, lanes: rng.gumbel(key, shape, lanes=lanes), None),
    "gamma": (lambda key, shape, lanes: rng.gamma(key, 0.3, shape, lanes=lanes), None),
}


@pytest.mark.parametrize("draw", sorted(LANE_DRAWS))
def test_lane_draws_are_the_global_draws_rows(draw):
    """A rank's draw over its lanes hashes only its own counters; its rows
    are the global draw's, which is JAX's where the port's draw is."""
    port, ref = LANE_DRAWS[draw]
    key = rng.PRNGKey(5)
    shape = (6,) if draw == "split" else (6, 3, 7)
    full = port(key, shape, None)
    want = None
    if ref is not None:
        want = np.asarray(ref(jax_key(key), shape)).astype(np.float32 if draw == "uniform" else np.int64)
    for lanes in (Lanes(0, 2, 6), Lanes(2, 5, 6), Lanes(5, 6, 6)):
        got = port(key, (lanes.hi - lanes.lo, *shape[1:]), lanes)
        assert torch.equal(got, full[lanes.lo: lanes.hi])
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), want[lanes.lo: lanes.hi])
    if draw != "gamma":
        with pytest.raises(ValueError, match="rows"):
            port(key, shape, Lanes(0, 2, 6))
