"""Parity of the port's tensor-parallel learner (the mesh's mdl axis:
`parallel/sharding.py`, `nn/model.py` `tensor_parallel_`,
`rl/trainer.py`) with the JAX package's.

- The layout leaf by leaf: the port's shards of a converted net (its
  `state_shardings` on the port's names, `tensor_parallel_` on a module)
  are the conversions of the JAX leaves' shards under JAX `_tp_spec`,
  at 2 heads (attention and MLP sharded) and at 1 head (attention
  replicated, MLP sharded).
- K = 2 learner steps on gloo ranks (`tests/torch_dp_rank.py`, no JAX)
  at (dp=1, mdl=2) and (dp=2, mdl=2; the clip by global norm firing)
  against the JAX `Trainer` on `MeshConfig(DP_SIZE=4, MDL_SIZE=2)`,
  within `test_torch_parallel_learner.py`'s bounds (metrics 1e-4
  relative; parameters rtol 2e-4, atol 2e-5 but for rounding-sized
  gradients, and for the entries where the JAX package's own
  replicated learner on `DP_SIZE=8` and its TP learner disagree beyond
  that bound: Adam's step on a gradient near zero tells apart
  roundings the two JAX layouts already differ in, so those entries
  are held to Adam's bound, like rounding-sized ones). The
  transformer's dropout is 0 on both sides: the frameworks draw masks
  from different generators. Every rank's whole
  state and digest are bit-equal; `sync_to_network` installs whole
  tensors, equal on the ranks.
- With dropout on, the (dp=1, mdl=2) learner draws the replicated
  learner's masks (the MLP's drawn whole and sliced): its parameters
  after 2 steps are the one-process port learner's within the same
  bound (its own rounding-sized entries held to Adam's), where a mask
  of other columns would move them by the gradient's order.
- Batch norm at (dp=1, mdl=2): the running statistics are the
  one-process learner's (not summed over the mdl replicas), within
  `test_torch_parallel_learner.py`'s bound on them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import alphatriangle_tpu.nn.model as jax_model  # noqa: E402
from alphatriangle_tpu.config import MeshConfig as JaxMeshConfig  # noqa: E402
from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.parallel.sharding import _tp_spec  # noqa: E402
from alphatriangle_tpu.rl.trainer import Trainer as JaxTrainer  # noqa: E402
from alphatriangle_tpu_torch.config.mesh_config import Mesh  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork, flax_to_torch  # noqa: E402
from alphatriangle_tpu_torch.nn.model import tensor_parallel_  # noqa: E402
from alphatriangle_tpu_torch.parallel.sharding import shard_tensor, state_shardings  # noqa: E402
from alphatriangle_tpu_torch.rl.trainer import Trainer  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    assert_params_within,
    collect_ranks,
    converted_state_dict,
    jax_adam_moments,
    rounding_sized,
    small_model_config,
    spawn_ranks,
    torch_cfg,
)

METRIC_RTOL = 1e-4
LR = 1e-3
MDL = 2


def _model_cfg(env_cfg, **kw):
    # 2 heads of 6 and an MLP of 16: every transformer width divides by 2.
    return small_model_config(env_cfg, **kw)


def _batch(env_cfg, model_cfg, n: int, seed: int) -> dict:
    pick = np.random.default_rng(seed)
    policy = pick.random((n, env_cfg.action_dim)).astype(np.float32) ** 3
    policy /= policy.sum(-1, keepdims=True)
    return {
        "grid": pick.integers(-1, 2, (n, 1, env_cfg.ROWS, env_cfg.COLS)).astype(np.float32),
        "other_features": pick.random((n, model_cfg.OTHER_NN_INPUT_FEATURES_DIM)).astype(np.float32),
        "policy_target": policy,
        "value_target": (pick.normal(size=n) * 6).astype(np.float32),
        "weights": pick.uniform(0.2, 1.0, n).astype(np.float32),
        "policy_weight": (pick.random(n) < 0.8).astype(np.float32),
    }


def _jax_chunks(leaf: np.ndarray, spec, i: int) -> np.ndarray:
    """Shard i of `MDL` of a JAX leaf under its PartitionSpec."""
    if spec is None:
        return leaf
    dim = next(d for d, ax in enumerate(spec) if ax == "mdl")
    return np.split(leaf, MDL, axis=dim)[i]


@pytest.mark.parametrize("heads", [2, 1])
def test_layout_matches_jax_tp_spec(tiny_env_config, heads):
    model_cfg = _model_cfg(tiny_env_config, TRANSFORMER_HEADS=heads)
    jnet = JaxNetwork(model_cfg, tiny_env_config, seed=3)
    params = jax.tree_util.tree_map(np.asarray, jnet.variables["params"])
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    specs = {
        "/".join(str(k.key) for k in path): _tp_spec("/".join(str(k.key) for k in path), leaf.shape, "mdl", MDL)
        for path, leaf in flat
    }
    full = flax_to_torch({"params": params})
    layout = state_shardings(full, Mesh(mdl=MDL), heads)
    converted = {name.replace("/", ".").replace(".kernel", ".weight").replace(".scale", ".weight"): spec
                 for name, spec in specs.items()}
    # The same leaves are sharded, under the port's names.
    assert {n for n, d in layout.items() if d != "replicated"} == {
        n for n, spec in converted.items() if spec is not None
    }
    if heads == 1:
        assert all(layout[n] == "replicated" for n in layout if "MultiHeadDotProductAttention" in n)
    assert layout["Dense_0.weight"] == "replicated"
    for i in range(MDL):
        want = flax_to_torch({"params": jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params),
            [_jax_chunks(leaf, specs["/".join(str(k.key) for k in path)], i) for path, leaf in flat],
        )})
        mesh = Mesh(mdl=MDL, mdl_index=i)
        net = NeuralNetwork(torch_cfg(model_cfg), torch_cfg(tiny_env_config), seed=0, device="cpu",
                            state_dict=converted_state_dict(jnet))
        tensor_parallel_(net.model, mesh)
        for name, p in net.model.named_parameters():
            dim = layout[name]
            mine = full[name] if dim == "replicated" else shard_tensor(full[name], dim, mesh)
            assert torch.equal(mine, want[name]), name
            assert torch.equal(p.detach(), want[name]), name


def _no_dropout_jax(monkeypatch):
    """The JAX transformer with dropout 0 (same module name, same params)."""
    layer = type("TransformerEncoderLayer", (jax_model.TransformerEncoderLayer,),
                 {"__annotations__": {"dropout_rate": float}, "dropout_rate": 0.0,
                  "__module__": jax_model.__name__})
    monkeypatch.setattr(jax_model, "TransformerEncoderLayer", layer)


def _spec(tmp_path, env_cfg, model_cfg, jcfg, jnet, batches, mesh: dict, dropout: list) -> dict:
    torch.save(converted_state_dict(jnet), tmp_path / "net.pt")
    np.savez(tmp_path / "batches.npz", batches=np.array(batches, dtype=object))
    return {
        "scenario": "tp_learner", "mesh": mesh, "dropout": dropout,
        "env": env_cfg.model_dump(), "model": model_cfg.model_dump(),
        "train": torch_cfg(jcfg).model_dump(), "state_dict": str(tmp_path / "net.pt"),
        "batches": str(tmp_path / "batches.npz"),
    }


def _jax_cfg(**kw) -> JaxTrainConfig:
    return JaxTrainConfig(
        AUTO_RESUME_LATEST=False, RUN_NAME="tp_learner", BATCH_SIZE=16, BUFFER_CAPACITY=64,
        MIN_BUFFER_SIZE_TO_TRAIN=16, MAX_TRAINING_STEPS=50, RANDOM_SEED=7, LEARNING_RATE=LR,
        ENTROPY_BONUS_WEIGHT=0.01, **kw,
    )


def _assert_replicas(ranks: list, key: str) -> None:
    r0 = ranks[0][key]
    for rk in ranks[1:]:
        rk = rk[key]
        assert rk["checksum"] == r0["checksum"] and rk["metrics"] == r0["metrics"]
        for part in ("params",):
            for name, t in r0["state"][part].items():
                assert torch.equal(t, rk["state"][part][name]), name
        for name, t in r0["synced"].items():
            assert torch.equal(t, rk["synced"][name]), name


@pytest.mark.parametrize("dp, clip", [(1, None), (2, 0.05)], ids=["dp1-mdl2", "dp2-mdl2-clip"])
def test_tp_steps_match_jax_tp_trainer(tmp_path, tiny_env_config, monkeypatch, dp, clip):
    model_cfg = _model_cfg(tiny_env_config)
    jcfg = _jax_cfg(GRADIENT_CLIP_VALUE=clip)
    _no_dropout_jax(monkeypatch)
    jnet = JaxNetwork(model_cfg, tiny_env_config, seed=3)
    batches = [_batch(tiny_env_config, model_cfg, 16, seed=s) for s in (1, 2)]
    procs, out = spawn_ranks(
        _spec(tmp_path, tiny_env_config, model_cfg, jcfg, jnet, batches,
              {"DP_SIZE": dp, "MDL_SIZE": MDL}, [False, True] if dp == 1 else [False]),
        tmp_path, world=dp * MDL,
    )
    jt = JaxTrainer(jnet, jcfg, mesh=JaxMeshConfig(DP_SIZE=4, MDL_SIZE=MDL).build_mesh())
    assert jt.tp_size == MDL
    jres = jt.train_steps(batches)
    jrep = JaxTrainer(JaxNetwork(model_cfg, tiny_env_config, seed=3), jcfg,
                      mesh=JaxMeshConfig(DP_SIZE=8).build_mesh())
    jrep.train_steps(batches)
    # The one-process port learner with dropout on, for the masks.
    tnet = NeuralNetwork(torch_cfg(model_cfg), torch_cfg(tiny_env_config), seed=0, device="cpu",
                         state_dict=converted_state_dict(jnet))
    tt = Trainer(tnet, torch_cfg(jcfg))
    tt.train_steps([dict(b) for b in batches])
    ranks = collect_ranks(procs, out)

    _assert_replicas(ranks, "no_dropout")
    r0 = ranks[0]["no_dropout"]
    if clip is not None:
        assert all(jm["grad_norm"] > clip for jm, _ in jres), "the clip must fire"
    for i, (jm, jtd) in enumerate(jres):
        for key in ("total_loss", "policy_loss", "value_loss", "entropy", "grad_norm"):
            np.testing.assert_allclose(r0["metrics"][i][key], jm[key], rtol=METRIC_RTOL, err_msg=key)
        # Each dp row's TD errors are its rows of the global batch (mdl
        # replicas hold the same rows).
        tds = np.concatenate([ranks[d * MDL]["no_dropout"]["td"][i] for d in range(dp)])
        np.testing.assert_allclose(tds, jtd, rtol=METRIC_RTOL, atol=1e-6)
    rounding = rounding_sized(jax_adam_moments(jt.state.opt_state)[1])
    tp_p, rep_p = (flax_to_torch({"params": jax.tree_util.tree_map(np.asarray, t.state.params)})
                   for t in (jt, jrep))
    for name, ref in tp_p.items():
        rounding[name] |= ((rep_p[name] - ref).abs() > 2e-5 + 2e-4 * ref.abs()).numpy()
    assert_params_within(r0["state"]["params"], jt.state.params, rounding, LR, 2)
    # The moments are whole too: the JAX learner's within Adam's noise.
    mu, nu, count = jax_adam_moments(jt.state.opt_state)
    assert r0["state"]["opt_state"]["count"] == count
    top = max(float(v.max()) for v in nu.values())
    for name, ref in nu.items():
        # Squared gradients: 1e-3 relative, and 1e-6 of the largest.
        np.testing.assert_allclose(r0["state"]["opt_state"]["nu"][name].numpy(), ref.numpy(),
                                   rtol=1e-3, atol=1e-6 * top, err_msg=name)
    # sync_to_network: whole tensors, the learner's parameters.
    for name, t in r0["state"]["params"].items():
        assert r0["synced"][name].shape == t.shape and torch.equal(r0["synced"][name], t), name
    assert r0["synced_version"] == 1
    # A rank's shards are its mdl slices of the whole parameters.
    layout = state_shardings(r0["state"]["params"], Mesh(mdl=MDL), model_cfg.TRANSFORMER_HEADS)
    assert any(d != "replicated" for d in layout.values())
    for r, rk in enumerate(ranks):
        mesh = Mesh(dp=dp, dp_index=r // MDL, mdl=MDL, mdl_index=r % MDL)
        for name, shard in rk["no_dropout"]["shards"].items():
            d = layout[name]
            want = r0["state"]["params"][name]
            assert torch.equal(shard, want if d == "replicated" else shard_tensor(want, d, mesh)), name
    if dp == 1:
        _assert_replicas(ranks, "dropout")
        got = ranks[0]["dropout"]["state"]["params"]
        one = tt.get_state()
        masks = rounding_sized(one["opt_state"]["nu"])
        for name, ref in one["params"].items():
            g, r, m = got[name].numpy(), ref.numpy(), masks[name]
            np.testing.assert_allclose(g[~m], r[~m], rtol=2e-4, atol=2e-5, err_msg=name)
            assert np.abs(g[m] - r[m]).max(initial=0.0) <= 2 * LR * 2, name


def test_tp_batch_norm_statistics_are_the_one_rank_learners(tmp_path, tiny_env_config):
    model_cfg = _model_cfg(tiny_env_config, NORM_TYPE="batch")
    jcfg = _jax_cfg(GRADIENT_CLIP_VALUE=5.0)
    jnet = JaxNetwork(model_cfg, tiny_env_config, seed=3)
    batches = [_batch(tiny_env_config, model_cfg, 16, seed=s) for s in (3, 4)]
    procs, out = spawn_ranks(
        _spec(tmp_path, tiny_env_config, model_cfg, jcfg, jnet, batches, {"MDL_SIZE": MDL}, [True]),
        tmp_path,
    )
    tnet = NeuralNetwork(torch_cfg(model_cfg), torch_cfg(tiny_env_config), seed=0, device="cpu",
                         state_dict=converted_state_dict(jnet))
    tt = Trainer(tnet, torch_cfg(jcfg))
    tt.train_steps([dict(b) for b in batches])
    ranks = collect_ranks(procs, out)
    _assert_replicas(ranks, "dropout")
    stats = ranks[0]["dropout"]["state"]["batch_stats"]
    want = tt.get_state()["batch_stats"]
    assert set(stats) == set(want) and stats
    for name, ref in want.items():
        # `test_torch_parallel_learner.py`'s bound: the second step's
        # batch means carry the biases the first step's Adam moved by up
        # to lr either way (rounding-sized gradients before a norm).
        atol = 1e-6 + (0.01 * 2 * LR if name.endswith("running_mean") else 0.0)
        np.testing.assert_allclose(stats[name].numpy(), ref.numpy(), rtol=1e-4, atol=atol, err_msg=name)
