"""The PyTorch port's checkpoints (`stats/persistence.py`), the buffer
snapshots, the learner's state and `nn/convert.py::train_state_from_flax`,
against the JAX package's contract and formats.

- The `CheckpointManager` contract, case for case as the JAX package's
  `tests/test_stats.py` holds its own: round trip, retention, an empty
  run, spills, explicit paths, the newest step, `find_latest_run`,
  `configs.json`, and the fallbacks past an uncommitted step,
  unparseable meta, an unreadable tree and a torn spill. Restored state
  is bit-equal.
- Cross-format, exact: a JAX spill loads into the port's host ring and
  its CPU device ring, and the next PER draws (slots and weights) equal
  the JAX ring's; a port spill loads into the JAX ring the same way;
  `configs.json` reads both ways.
- A JAX learner checkpointed by its own manager and carried across by
  `train_state_from_flax` takes one more step as the JAX learner does:
  losses and TD errors within 1e-4 relative, parameters within 1e-3 of
  the learning rate apart from Adam's sign flips on rounding-sized
  gradients (`torch_parity.assert_params_close`).
- Preemption: `request_preempt()` from another thread ends the loop
  PREEMPTED after a save at the step it reports; `cli train` given
  SIGTERM exits 114.
"""

import json
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from alphatriangle_tpu.config import PersistenceConfig as JaxPersistence  # noqa: E402
from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.config.run_configs import load_run_configs as jax_load_run_configs  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.rl.buffer import ExperienceBuffer as JaxBuffer  # noqa: E402
from alphatriangle_tpu.rl.trainer import Trainer as JaxTrainer  # noqa: E402
from alphatriangle_tpu.stats.persistence import CheckpointManager as JaxManager  # noqa: E402
from alphatriangle_tpu_torch.config import PersistenceConfig, TrainConfig  # noqa: E402
from alphatriangle_tpu_torch.config.run_configs import (  # noqa: E402
    load_run_configs,
    load_run_configs_or_default,
)
from alphatriangle_tpu_torch.nn import NeuralNetwork, flax_to_torch, train_state_from_flax  # noqa: E402
from alphatriangle_tpu_torch.rl import DeviceReplayBuffer, Trainer  # noqa: E402
from alphatriangle_tpu_torch.rl.buffer import ExperienceBuffer  # noqa: E402
from alphatriangle_tpu_torch.stats import CheckpointManager  # noqa: E402
from alphatriangle_tpu_torch.training import LoopStatus, TrainingLoop, setup_training_components  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    CPU,
    assert_params_close,
    dense_rows,
    run_root,
    small_model_config,
    torch_cfg,
)

ROOT = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-4


def _ring_cfg(**kw) -> JaxTrainConfig:
    base = dict(
        BATCH_SIZE=6, BUFFER_CAPACITY=40, MIN_BUFFER_SIZE_TO_TRAIN=10, USE_PER=True,
        PER_BETA_ANNEAL_STEPS=10, AUTO_RESUME_LATEST=False, RUN_NAME="ckpt", RANDOM_SEED=3,
        MAX_TRAINING_STEPS=10,
    )
    base.update(kw)
    return JaxTrainConfig(**base)


def _rows(env_cfg, n: int, seed: int) -> dict:
    return dense_rows(seed, n, (1, env_cfg.ROWS, env_cfg.COLS), 14, env_cfg.action_dim)


def _filled(buf, env_cfg, n: int = 20, seed: int = 0):
    """`buf` with `n` rows (wrapping a 40-slot ring past n = 40) and TD
    priorities on all of them."""
    buf.add_dense(**_rows(env_cfg, n, seed))
    size = len(buf)
    buf.update_priorities(np.arange(size), np.linspace(0.5, 3.0, size))
    return buf


def _trainer(env_cfg, model_cfg, seed: int = 0) -> Trainer:
    net = NeuralNetwork(torch_cfg(model_cfg), torch_cfg(env_cfg), seed=seed, device=CPU)
    return Trainer(net, TrainConfig(BATCH_SIZE=4, BUFFER_CAPACITY=100, MIN_BUFFER_SIZE_TO_TRAIN=10))


def _batch(env_cfg, seed: int = 0, n: int = 4) -> dict:
    rows = _rows(env_cfg, n, seed)
    return {**rows, "weights": np.ones(n, np.float32)}


def _assert_state_equal(got: dict, want: dict) -> None:
    assert got["step"] == want["step"] and got["opt_state"]["count"] == want["opt_state"]["count"]
    assert torch.equal(got["rng"], want["rng"])
    for part in ("params", "mu", "nu"):
        a = got["params"] if part == "params" else got["opt_state"][part]
        b = want["params"] if part == "params" else want["opt_state"][part]
        assert set(a) == set(b), part
        for name in a:
            assert torch.equal(a[name].cpu(), b[name].cpu()), (part, name)


def _per_cfg(tmp_path, run: str = "run_a", **kw) -> PersistenceConfig:
    return PersistenceConfig(ROOT_DATA_DIR=str(tmp_path), RUN_NAME=run, **kw)


# --- the CheckpointManager contract -------------------------------------------


def _case_round_trip(tmp_path, env_cfg, model_cfg):
    trainer = _trainer(env_cfg, model_cfg)
    trainer.train_step(_batch(env_cfg))
    mgr = CheckpointManager(_per_cfg(tmp_path))
    mgr.save(1, trainer.get_state(), counters={"episodes_played": 5, "total_simulations": 99})
    fresh = _trainer(env_cfg, model_cfg, seed=123)
    loaded = mgr.restore()
    assert loaded.global_step == 1 and loaded.counters["episodes_played"] == 5
    assert loaded.run_name == "run_a" and not loaded.buffer_loaded
    fresh.set_state(loaded.train_state)
    _assert_state_equal(fresh.get_state(), trainer.get_state())
    # Installed copies: the loaded tensors stay as they were after a step.
    before = {k: v.clone() for k, v in loaded.train_state["params"].items()}
    fresh.train_step(_batch(env_cfg, seed=1))
    assert all(torch.equal(before[k], v) for k, v in loaded.train_state["params"].items())
    # A save keeps no reference to the live tensors.
    saved = trainer.get_state()
    trainer.train_step(_batch(env_cfg, seed=2))
    assert not all(torch.equal(saved["params"][n], p) for n, p in trainer.model.named_parameters())


def _case_retention(tmp_path, env_cfg, model_cfg):
    trainer = _trainer(env_cfg, model_cfg)
    cfg = _per_cfg(tmp_path, KEEP_LAST_CHECKPOINTS=2, KEEP_LAST_BUFFERS=1)
    mgr = CheckpointManager(cfg)
    for step in (1, 2, 3, 4):
        mgr.save(step, trainer.get_state())
    kept = sorted(p.name for p in cfg.get_checkpoint_dir().iterdir() if p.is_dir())
    assert kept == ["step_00000003", "step_00000004"]
    metas = sorted(p.name for p in cfg.get_checkpoint_dir().glob("*.meta.json"))
    assert metas == ["step_00000003.meta.json", "step_00000004.meta.json"]
    commits = sorted(p.name for p in cfg.get_checkpoint_dir().glob("*.commit"))
    assert commits == ["step_00000003.commit", "step_00000004.commit"]
    assert mgr.latest_step() == 4
    buf = _filled(ExperienceBuffer(torch_cfg(_ring_cfg())), env_cfg, n=4)
    for step in (1, 2, 3):
        mgr.save_buffer(step, buf)
    assert sorted(p.name for p in cfg.get_buffer_dir().iterdir()) == ["buffer_00000003.npz"]


def _case_retention_zero(tmp_path, env_cfg, model_cfg):
    trainer = _trainer(env_cfg, model_cfg)
    cfg = _per_cfg(tmp_path, KEEP_LAST_CHECKPOINTS=0)
    mgr = CheckpointManager(cfg)
    for step in (1, 2, 3):
        mgr.save(step, trainer.get_state())
    assert len([p for p in cfg.get_checkpoint_dir().iterdir() if p.is_dir()]) == 3


def _case_empty_run(tmp_path, env_cfg, model_cfg):
    loaded = CheckpointManager(_per_cfg(tmp_path)).restore()
    assert loaded.train_state is None and loaded.global_step == 0


def _case_spill_round_trip(tmp_path, env_cfg, model_cfg):
    tc = torch_cfg(_ring_cfg())
    buf = _filled(ExperienceBuffer(tc), env_cfg, n=55)  # wrapped: 40 slots, cursor 15
    mgr = CheckpointManager(_per_cfg(tmp_path))
    mgr.save_buffer(7, buf)
    restored = ExperienceBuffer(tc)
    assert mgr.restore_buffer(restored) and len(restored) == 40
    # Chronological order: the oldest row (slot 15) lands in slot 0.
    order = np.roll(np.arange(40), -15)
    for name, col in buf._storage.items():
        np.testing.assert_array_equal(restored._storage[name], col[order], err_msg=name)
    leaves = buf.tree.tree[buf.tree._cap2 : buf.tree._cap2 + 40]
    np.testing.assert_array_equal(restored.tree.tree[restored.tree._cap2 :][:40], leaves[order])
    assert restored.tree.total_priority == pytest.approx(buf.tree.total_priority, rel=1e-12)
    assert (restored._pos, restored.tree.data_pointer, restored.tree.n_entries) == (0, 0, 40)
    # A smaller ring keeps the newest rows, and every other leaf is zero.
    small = ExperienceBuffer(torch_cfg(_ring_cfg(BUFFER_CAPACITY=16, MIN_BUFFER_SIZE_TO_TRAIN=8)))
    _filled(small, env_cfg, n=16, seed=9)
    small.update_priorities(np.arange(16), np.full(16, 50.0))
    assert mgr.restore_buffer(small) and len(small) == 16
    np.testing.assert_array_equal(small._storage["value_target"], buf._storage["value_target"][order][-16:])
    assert small.tree.max_priority == pytest.approx(max(1.0, leaves.max()))


def _case_explicit_paths(tmp_path, env_cfg, model_cfg):
    trainer = _trainer(env_cfg, model_cfg)
    mgr = CheckpointManager(_per_cfg(tmp_path))
    mgr.save(5, trainer.get_state(), counters={"episodes_played": 2})
    path = _per_cfg(tmp_path).get_checkpoint_dir() / "step_00000005"
    other = CheckpointManager(_per_cfg(tmp_path, "other_run"))
    loaded = other.restore_path(path)
    assert loaded.global_step == 5 and loaded.counters["episodes_played"] == 2
    _assert_state_equal(loaded.train_state, trainer.get_state())
    with pytest.raises(FileNotFoundError):
        other.restore_path(tmp_path / "nope")
    tc = torch_cfg(_ring_cfg(USE_PER=False))
    buf = ExperienceBuffer(tc)
    buf.add_dense(**_rows(env_cfg, 10, 0))
    spill = mgr.save_buffer(3, buf)
    buf2 = ExperienceBuffer(tc)
    assert other.restore_buffer_path(buf2, spill) and len(buf2) == 10
    with pytest.raises(FileNotFoundError):
        other.restore_buffer_path(buf2, tmp_path / "nope.npz")


def _case_latest_step(tmp_path, env_cfg, model_cfg):
    trainer = _trainer(env_cfg, model_cfg)
    mgr = CheckpointManager(_per_cfg(tmp_path))
    mgr.save(3, trainer.get_state())
    mgr.save(12, trainer.get_state())
    assert mgr.latest_step() == 12 and mgr.valid_steps() == [3, 12]
    # A forced save of a step already saved replaces it.
    trainer.train_step(_batch(env_cfg))
    mgr.save(12, trainer.get_state())
    _assert_state_equal(mgr.restore().train_state, trainer.get_state())


def _case_find_latest_run(tmp_path, env_cfg, model_cfg):
    trainer = _trainer(env_cfg, model_cfg)
    CheckpointManager(_per_cfg(tmp_path, "run_a")).save(1, trainer.get_state())
    time.sleep(0.05)
    CheckpointManager(_per_cfg(tmp_path, "run_b")).save(2, trainer.get_state())
    CheckpointManager(_per_cfg(tmp_path, "run_c"))  # directories, no checkpoint
    assert CheckpointManager.find_latest_run(_per_cfg(tmp_path)) == "run_b"
    assert CheckpointManager.find_latest_run(_per_cfg(tmp_path / "empty")) is None


def _case_configs(tmp_path, env_cfg, model_cfg):
    mgr = CheckpointManager(_per_cfg(tmp_path))
    mgr.save_configs({"env": torch_cfg(env_cfg), "note": "x"})
    data = json.loads((_per_cfg(tmp_path).get_run_base_dir() / "configs.json").read_text())
    assert data["env"]["ROWS"] == 3 and data["note"] == "x"


def _case_uncommitted_step(tmp_path, env_cfg, model_cfg):
    trainer = _trainer(env_cfg, model_cfg)
    cfg = _per_cfg(tmp_path)
    mgr = CheckpointManager(cfg)
    mgr.save(1, trainer.get_state())
    mgr.save(2, trainer.get_state())
    torn = cfg.get_checkpoint_dir() / "step_00000003"  # killed before its marker
    torn.mkdir()
    (torn / "train_state.pt").write_bytes(b"\x00\x01garbage")
    (cfg.get_checkpoint_dir() / "step_00000003.meta.json").write_text(json.dumps({"global_step": 3}))
    assert mgr.valid_steps() == [1, 2] and mgr.latest_step() == 2
    assert mgr.restore().global_step == 2


def _case_unparseable_meta(tmp_path, env_cfg, model_cfg):
    trainer = _trainer(env_cfg, model_cfg)
    cfg = _per_cfg(tmp_path)
    mgr = CheckpointManager(cfg)
    mgr.save(1, trainer.get_state())
    mgr.save(2, trainer.get_state())
    (cfg.get_checkpoint_dir() / "step_00000002.meta.json").write_text("{torn mid-write")
    assert mgr.valid_steps() == [1] and mgr.restore().global_step == 1


def _case_unreadable_tree(tmp_path, env_cfg, model_cfg):
    trainer = _trainer(env_cfg, model_cfg)
    cfg = _per_cfg(tmp_path)
    mgr = CheckpointManager(cfg)
    mgr.save(1, trainer.get_state())
    mgr.save(2, trainer.get_state())
    step2 = cfg.get_checkpoint_dir() / "step_00000002"
    shutil.rmtree(step2)
    step2.mkdir()  # marker present, tree gutted
    assert mgr.restore().global_step == 1
    with pytest.raises(Exception):
        mgr.restore(step=2)


def _case_torn_spill(tmp_path, env_cfg, model_cfg):
    tc = torch_cfg(_ring_cfg(USE_PER=False))
    buf = ExperienceBuffer(tc)
    buf.add_dense(**_rows(env_cfg, 10, 0))
    cfg = _per_cfg(tmp_path)
    mgr = CheckpointManager(cfg)
    mgr.save_buffer(3, buf)
    (cfg.get_buffer_dir() / "buffer_00000009.npz").write_bytes(b"PK\x03\x04 torn")
    buf2 = ExperienceBuffer(tc)
    assert mgr.restore_buffer(buf2) and len(buf2) == 10
    assert mgr.restore_buffer(ExperienceBuffer(tc), max_step=2) is False


def _case_torn_only_run(tmp_path, env_cfg, model_cfg):
    trainer = _trainer(env_cfg, model_cfg)
    CheckpointManager(_per_cfg(tmp_path, "run_good")).save(1, trainer.get_state())
    time.sleep(0.05)
    torn = _per_cfg(tmp_path, "run_torn")
    torn.create_run_dirs()
    (torn.get_checkpoint_dir() / "step_00000002").mkdir()
    (torn.get_checkpoint_dir() / "step_00000001.commit").write_text('{"global_step": 1}')
    assert CheckpointManager.find_latest_run(_per_cfg(tmp_path)) == "run_good"


CONTRACT = {
    "round_trip": _case_round_trip,
    "retention": _case_retention,
    "retention_zero": _case_retention_zero,
    "empty_run": _case_empty_run,
    "spill_round_trip": _case_spill_round_trip,
    "explicit_paths": _case_explicit_paths,
    "latest_step": _case_latest_step,
    "find_latest_run": _case_find_latest_run,
    "configs": _case_configs,
    "uncommitted_step": _case_uncommitted_step,
    "unparseable_meta": _case_unparseable_meta,
    "unreadable_tree": _case_unreadable_tree,
    "torn_spill": _case_torn_spill,
    "torn_only_run": _case_torn_only_run,
}


@pytest.mark.parametrize("case", list(CONTRACT))
def test_checkpoint_manager_contract(case, tmp_path, tiny_env_config, tiny_model_config):
    CONTRACT[case](tmp_path, tiny_env_config, tiny_model_config)


def test_persistence_layout_is_the_ports_own(tmp_path):
    """The JAX layout under the port's own app directory, and a JAX dump
    loads unchanged."""
    jcfg = JaxPersistence(ROOT_DATA_DIR=str(tmp_path), RUN_NAME="r", KEEP_LAST_BUFFERS=3)
    cfg = PersistenceConfig(**{**jcfg.model_dump(), "APP_NAME": PersistenceConfig().APP_NAME})
    assert cfg.APP_NAME == "AlphaTriangleTPUTorch" != jcfg.APP_NAME
    for getter in ("get_checkpoint_dir", "get_buffer_dir", "get_log_dir", "get_profile_dir"):
        ours, theirs = getattr(cfg, getter)(), getattr(jcfg, getter)()
        assert ours.relative_to(cfg.get_app_root_dir()) == theirs.relative_to(jcfg.get_app_root_dir())
    assert PersistenceConfig(**jcfg.model_dump()).model_dump() == jcfg.model_dump()
    with pytest.raises(ValueError):
        PersistenceConfig(BUFFER_SAVE_FREQ_STEPS=0)


# --- cross-format -------------------------------------------------------------


def _draws(buf, n: int = 3, step: int = 4) -> list:
    return [buf.sample(6, current_train_step=step) for _ in range(n)]


def _assert_same_draws(got: list, want: list) -> None:
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g["indices"], w["indices"])
        np.testing.assert_array_equal(g["weights"], w["weights"])


@pytest.mark.parametrize("ring", ["host", "device"])
def test_jax_spill_loads_into_the_port_rings(ring, tmp_path, tiny_env_config):
    jtc = _ring_cfg()
    jbuf = _filled(JaxBuffer(jtc, action_dim=tiny_env_config.action_dim), tiny_env_config, n=55)
    spill = JaxManager(JaxPersistence(ROOT_DATA_DIR=str(tmp_path), RUN_NAME="j")).save_buffer(4, jbuf)
    jrestored = JaxBuffer(jtc, action_dim=tiny_env_config.action_dim)
    JaxManager.restore_buffer_path(jrestored, spill)
    tc = torch_cfg(jtc)
    if ring == "host":
        ours = ExperienceBuffer(tc, action_dim=tiny_env_config.action_dim)
    else:
        ours = DeviceReplayBuffer(
            tc, grid_shape=(1, tiny_env_config.ROWS, tiny_env_config.COLS), other_dim=14,
            action_dim=tiny_env_config.action_dim, device=CPU,
        )
    assert CheckpointManager(run_root(tmp_path)).restore_buffer_path(ours, spill)
    assert (len(ours), ours._pos) == (len(jrestored), jrestored._pos)
    np.testing.assert_array_equal(ours.tree.tree, jrestored.tree.tree)
    if ring == "device":
        for name, col in jrestored._storage.items():
            np.testing.assert_array_equal(ours.storage[name][:40].numpy(), col, err_msg=name)
            assert not ours.storage[name][40].any()  # the trash row
        assert ours._storage is None
        snap = ours.get_state()
        for name, col in jrestored._storage.items():
            np.testing.assert_array_equal(snap["storage"][name], col, err_msg=name)
    _assert_same_draws(_draws(ours), _draws(jrestored))


def test_port_spill_loads_into_the_jax_ring(tmp_path, tiny_env_config):
    jtc = _ring_cfg()
    ours = _filled(ExperienceBuffer(torch_cfg(jtc)), tiny_env_config, n=33)
    spill = CheckpointManager(run_root(tmp_path)).save_buffer(4, ours)
    theirs = JaxBuffer(jtc, action_dim=tiny_env_config.action_dim)
    JaxManager.restore_buffer_path(theirs, spill)
    again = ExperienceBuffer(torch_cfg(jtc))
    CheckpointManager(run_root(tmp_path)).restore_buffer_path(again, spill)
    np.testing.assert_array_equal(theirs.tree.tree, again.tree.tree)
    for name, col in again._storage.items():
        np.testing.assert_array_equal(theirs._storage[name], col, err_msg=name)
    _assert_same_draws(_draws(again), _draws(theirs))


def test_configs_json_reads_both_ways(tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config):
    jdir = tmp_path / "jax"
    jmgr = JaxManager(JaxPersistence(ROOT_DATA_DIR=str(jdir), RUN_NAME="r"))
    jmgr.save_configs({"env": tiny_env_config, "model": tiny_model_config, "train": _ring_cfg()})
    loaded = load_run_configs(JaxPersistence(ROOT_DATA_DIR=str(jdir), RUN_NAME="r").get_run_base_dir())
    assert loaded["env"] == torch_cfg(tiny_env_config)
    assert loaded["model"] == torch_cfg(tiny_model_config)
    c = setup_training_components(
        torch_cfg(_ring_cfg()), torch_cfg(tiny_env_config), torch_cfg(tiny_model_config),
        torch_cfg(tiny_mcts_config), persistence_config=run_root(tmp_path), device=CPU,
    )
    theirs = jax_load_run_configs(c.persistence_config.get_run_base_dir())
    assert theirs["env"] == tiny_env_config and theirs["model"] == tiny_model_config
    dump = json.loads((c.persistence_config.get_run_base_dir() / "configs.json").read_text())
    assert set(dump) == {"env", "model", "train", "mcts", "persistence"}
    assert JaxTrainConfig(**dump["train"]).model_dump() == _ring_cfg().model_dump()
    env, _ = load_run_configs_or_default(tmp_path / "nowhere")
    assert env.ROWS == 8 and env.COLS == 15


# --- a JAX learner carried across -------------------------------------------


def _adam_state(opt_state):
    """The ScaleByAdamState (count, mu, nu) inside the optax chain."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam_state(part)
            if found is not None:
                return found
    return None


def jax_train_state(jstate) -> dict:
    """`train_state_from_flax` of a JAX TrainState."""
    host = jax.tree_util.tree_map(np.asarray, jstate)
    adam = _adam_state(host.opt_state)
    return train_state_from_flax(
        host.params, adam.mu, adam.nu, adam.count, host.step, host.rng, batch_stats=host.batch_stats
    )


def test_train_state_from_flax_continues_the_jax_learner(tmp_path, tiny_env_config):
    model_cfg = small_model_config(tiny_env_config, USE_TRANSFORMER=False, TRANSFORMER_LAYERS=0)
    jcfg = _ring_cfg(
        BATCH_SIZE=16, BUFFER_CAPACITY=64, MIN_BUFFER_SIZE_TO_TRAIN=16, MAX_TRAINING_STEPS=50,
        RANDOM_SEED=7, LEARNING_RATE=1e-3,
    )
    jnet = JaxNetwork(model_cfg, tiny_env_config, seed=3)
    jtrainer = JaxTrainer(jnet, jcfg)
    other = model_cfg.OTHER_NN_INPUT_FEATURES_DIM

    def batch(seed):
        rows = dense_rows(seed, 16, (1, 3, 4), other, tiny_env_config.action_dim)
        return {**rows, "weights": np.random.default_rng(seed).uniform(0.2, 1, 16).astype(np.float32)}

    for seed in (1, 2):
        jtrainer.train_step(batch(seed))
    jmgr = JaxManager(JaxPersistence(ROOT_DATA_DIR=str(tmp_path), RUN_NAME="j"))
    jmgr.save(2, jtrainer.state, counters={"episodes_played": 3})
    jmgr.wait_until_finished()
    template = JaxTrainer(JaxNetwork(model_cfg, tiny_env_config, seed=11), jcfg)
    loaded = jmgr.restore(template.state)
    jmgr.close()
    state = jax_train_state(loaded.train_state)
    assert state["step"] == 2 and state["opt_state"]["count"] == 2
    np.testing.assert_array_equal(state["rng"].numpy(), np.asarray(jtrainer.state.rng))

    # Through the port's own checkpoint, into a learner of another seed.
    mgr = CheckpointManager(run_root(tmp_path, "port"))
    mgr.save(2, state, counters=loaded.counters)
    net = NeuralNetwork(torch_cfg(model_cfg), torch_cfg(tiny_env_config), seed=99, device=CPU)
    trainer = Trainer(net, torch_cfg(jcfg))
    trainer.set_state(mgr.restore().train_state)
    trainer.sync_to_network()
    want = flax_to_torch({"params": jax.tree_util.tree_map(np.asarray, jtrainer.state.params)})
    for name, p in trainer.model.named_parameters():
        assert torch.equal(p.detach(), want[name]), name
        assert torch.equal(net.model.state_dict()[name], want[name]), name
    assert trainer.global_step == jtrainer.global_step == 2

    b = batch(3)
    (m, td), (jm, jtd) = trainer.train_step(b), jtrainer.train_step(b)
    for key, ref in jm.items():
        np.testing.assert_allclose(m[key], ref, rtol=LOSS_RTOL, err_msg=key)
    np.testing.assert_allclose(td, np.asarray(jtd), rtol=LOSS_RTOL, atol=1e-6)
    assert_params_close(trainer.model, jtrainer.state.params, lr=1e-3, steps=1)
    assert torch.equal(trainer.state.rng, torch.from_numpy(np.asarray(jtrainer.state.rng).astype(np.int64)))


# --- preemption ---------------------------------------------------------------


def test_request_preempt_saves_and_reports(tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config):
    jtc = _ring_cfg(
        SELF_PLAY_BATCH_SIZE=4, ROLLOUT_CHUNK_MOVES=4, BATCH_SIZE=8, BUFFER_CAPACITY=2000,
        MIN_BUFFER_SIZE_TO_TRAIN=16, MAX_TRAINING_STEPS=10_000, CHECKPOINT_SAVE_FREQ_STEPS=1000,
        N_STEP_RETURNS=2, MAX_EPISODE_MOVES=30, RANDOM_SEED=5,
    )
    c = setup_training_components(
        torch_cfg(jtc), torch_cfg(tiny_env_config), torch_cfg(tiny_model_config),
        torch_cfg(tiny_mcts_config), persistence_config=run_root(tmp_path), device=CPU,
    )
    loop = TrainingLoop(c)

    def preempt_after_two_steps():
        while loop.global_step < 2 and loop.status is None:
            time.sleep(0.01)
        loop.request_preempt()

    t = threading.Thread(target=preempt_after_two_steps)
    t.start()
    status = loop.run()
    t.join()
    assert status == LoopStatus.PREEMPTED and 2 <= loop.global_step < 1000
    report = json.loads((c.persistence_config.get_run_base_dir() / "preempt_report.json").read_text())
    assert report["kind"] == "preempt" and report["exit_code"] == 114
    assert report["checkpointed_step"] == report["step"] == loop.global_step
    step = report["checkpointed_step"]
    assert c.checkpoints.latest_step() == step
    assert (c.persistence_config.get_buffer_dir() / f"buffer_{step:08d}.npz").is_file()
    _assert_state_equal(c.checkpoints.restore().train_state, c.trainer.get_state())


def test_cli_train_exits_114_on_sigterm(tmp_path):
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "alphatriangle_tpu_torch.cli", "train", "--device", "cpu",
            "--max-steps", "1000", "--self-play-batch", "2", "--batch-size", "4",
            "--min-buffer", "4", "--buffer-capacity", "64", "--rollout-chunk", "4",
            "--seed", "1", "--root-dir", str(tmp_path), "--run-name", "ckpt",
            "--checkpoint-freq", "2", "--no-tensorboard",
        ],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    run_dir = tmp_path / "AlphaTriangleTPUTorch" / "runs" / "ckpt"
    marker = run_dir / "checkpoints" / "step_00000002.commit"
    deadline = time.monotonic() + 120
    while not marker.exists() and proc.poll() is None and time.monotonic() < deadline:
        time.sleep(0.05)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 114, err[-2000:]
    report = json.loads(out.strip().splitlines()[-1])
    assert report["status"] == "preempted" and report["run_name"] == "ckpt"
    step = report["checkpointed_step"]
    preempt = json.loads((run_dir / "preempt_report.json").read_text())
    assert preempt["checkpointed_step"] == step == report["buffer_saved_step"] >= 2
    assert (run_dir / "checkpoints" / f"step_{step:08d}.commit").is_file()
    assert (run_dir / "buffers" / f"buffer_{step:08d}.npz").is_file()
