"""Parity of the PyTorch port's fused megastep (`rl/megastep.py`) with
the JAX `MegastepRunner` (the loop and the `train` command are in
`test_torch_train.py`).

Both sides start from the same net (`flax_to_torch`), the same configs
(the JAX megastep tests' tiny world, `tests/test_megastep.py`, with
2-move chunks) and the same seeds, warm the ring up to the batch size
and run one megastep. The port's Gumbel and gamma draws go through
`jax.random` for the same keys. Exact: the rows each chunk ingests, the
ring's slots (apart from the n-step returns, which take float sums in
another order: 1e-5, and the scalar features, within one ulp where XLA
rewrites a chain of divisions inside the jitted chunk), the sampled
slots (all priorities sit at the same
watermark, so the cumsum is exact) and the ring counters. Within
tolerance: losses and TD errors 1e-4 relative (gradients summed in
another order), parameters 1e-3 of the learning rate per step apart
from Adam's sign flips on rounding-sized gradients, and the device
priorities against the host mirror 1e-4 (float32 against float64).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.env.engine import TriangleEnv as JaxEnv  # noqa: E402
from alphatriangle_tpu.features.core import get_feature_extractor  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.rl.device_buffer import DeviceReplayBuffer as JaxRing  # noqa: E402
from alphatriangle_tpu.rl.megastep import MegastepRunner as JaxRunner  # noqa: E402
from alphatriangle_tpu.rl.self_play import SelfPlayEngine as JaxEngine  # noqa: E402
from alphatriangle_tpu.rl.trainer import Trainer as JaxTrainer  # noqa: E402
from alphatriangle_tpu_torch.ops import KERNELS  # noqa: E402
from alphatriangle_tpu_torch.rl.megastep import last_write_slots  # noqa: E402
from alphatriangle_tpu_torch.training import setup_training_components  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    CPU,
    converted_state_dict,
    inject_jax_noise,
    run_root,
    torch_cfg,
)

SUM_ATOL = 1e-5
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _jax_noise(monkeypatch):
    inject_jax_noise(monkeypatch)


def make_cfg(**kw) -> JaxTrainConfig:
    """The JAX megastep tests' config (tests/test_megastep.py:56-78)."""
    base = dict(
        RUN_NAME="mega_parity", AUTO_RESUME_LATEST=False, MAX_TRAINING_STEPS=8,
        SELF_PLAY_BATCH_SIZE=4, ROLLOUT_CHUNK_MOVES=2, BATCH_SIZE=8, BUFFER_CAPACITY=2000,
        MIN_BUFFER_SIZE_TO_TRAIN=16, USE_PER=True, PER_BETA_ANNEAL_STEPS=8, N_STEP_RETURNS=2,
        WORKER_UPDATE_FREQ_STEPS=2, CHECKPOINT_SAVE_FREQ_STEPS=4, MAX_EPISODE_MOVES=30,
        RANDOM_SEED=5, FUSED_MEGASTEP=True, DEVICE_REPLAY="on", FUSED_LEARNER_STEPS=2,
    )
    base.update(kw)
    return JaxTrainConfig(**base)


def _jax_side(env_cfg, model_cfg, mcts_cfg, tc):
    """JAX (engine, trainer, ring, runner) built as its setup builds them."""
    env = JaxEnv(env_cfg)
    net = JaxNetwork(model_cfg, env_cfg, seed=tc.RANDOM_SEED)
    trainer = JaxTrainer(net, tc)
    ring = JaxRing(
        tc, grid_shape=(1, env_cfg.ROWS, env_cfg.COLS),
        other_dim=get_feature_extractor(env, model_cfg).other_dim, action_dim=env_cfg.action_dim,
    )
    engine = JaxEngine(
        env, get_feature_extractor(env, model_cfg), net, mcts_cfg, tc, seed=tc.RANDOM_SEED + 1
    )
    runner = JaxRunner(engine, trainer, ring, tc)
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
    return engine, trainer, ring, runner, net, outs


def _warm_up(engine, ring, tc):
    """Warm-up chunks into the ring until it holds a batch; the counts."""
    need = max(tc.MIN_BUFFER_SIZE_TO_TRAIN, tc.BATCH_SIZE)
    counts = []
    while len(ring) < need:
        _, payload = engine.play_moves_device(tc.ROLLOUT_CHUNK_MOVES)
        counts.append(ring.ingest_payload(payload))
    return counts


class TestMegastep:
    def test_one_megastep_matches_jax(
        self, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
    ):
        jtc = make_cfg()
        jeng, jtrainer, jring, jrunner, jnet, jouts = _jax_side(
            tiny_env_config, tiny_model_config, tiny_mcts_config, jtc
        )
        c = setup_training_components(
            torch_cfg(jtc), torch_cfg(tiny_env_config), torch_cfg(tiny_model_config),
            torch_cfg(tiny_mcts_config), persistence_config=run_root(tmp_path), device=CPU,
        )
        c.net.model.load_state_dict(converted_state_dict(jnet))

        assert _warm_up(c.self_play, c.buffer, jtc) == _warm_up(jeng, jring, jtc)
        jrunner.sync_priorities_from_host()
        c.megastep.sync_priorities_from_host()
        k = jtc.FUSED_LEARNER_STEPS
        jres, jcount = jrunner.run_megastep(jtc.ROLLOUT_CHUNK_MOVES, k)
        before = {name: kern.launches for name, kern in KERNELS.items()}
        res, count = c.megastep.run_megastep(jtc.ROLLOUT_CHUNK_MOVES, k)
        assert {name: kern.launches for name, kern in KERNELS.items()} == before

        assert count == jcount > 0
        assert (c.buffer._pos, len(c.buffer)) == (jring._pos, len(jring))
        np.testing.assert_array_equal(c.megastep.last_idx, np.asarray(jouts[0]["idx"]))
        cap = jtc.BUFFER_CAPACITY
        for name, col in jring.storage.items():
            got, want = c.buffer.storage[name][:cap].numpy(), np.asarray(col)[:cap]
            if name == "value_target":
                np.testing.assert_allclose(got, want, atol=SUM_ATOL)
            elif name == "other_features":
                np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
        for (m, td), (jm, jtd) in zip(res, jres):
            for key in ("total_loss", "policy_loss", "value_loss", "entropy", "grad_norm"):
                np.testing.assert_allclose(m[key], jm[key], rtol=LOSS_RTOL, err_msg=key)
            assert m["learning_rate"] == pytest.approx(jm["learning_rate"], rel=1e-6)
            np.testing.assert_allclose(td, jtd, rtol=LOSS_RTOL, atol=1e-6)
        assert c.trainer.global_step == jtrainer.global_step == k

        lr = jtc.LEARNING_RATE
        want = converted_state_dict(type("N", (), {"variables": {"params": jtrainer.state.params}}))
        for name, p in c.net.model.named_parameters():
            diff = np.abs(p.detach().numpy() - want[name].numpy())
            assert (diff > 1e-3 * lr * k).mean() <= 0.01, (name, diff.max())
            assert diff.max() <= 2 * lr * k, (name, diff.max())

        # Device priorities equal the host mirror, on both sides alike.
        size = len(c.buffer)
        tree = c.buffer.tree
        host = tree.tree[np.arange(size) + tree._cap2]
        dev = c.megastep.priorities[:size].numpy()
        np.testing.assert_allclose(dev, host, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(dev, np.asarray(jrunner._priorities)[:size], rtol=1e-4, atol=1e-6)
        assert float(c.megastep.priorities[cap]) == 0.0
        assert c.self_play._episodes_played == jeng._episodes_played

    def test_last_write_wins_on_duplicate_slots(self):
        idx = torch.tensor([4, 7, 4, 9, 7, 4])
        slots = last_write_slots(idx, trash=99)
        assert slots.tolist() == [99, 99, 99, 9, 7, 4]
        prio = torch.zeros(100)
        prio.index_put_((slots,), torch.arange(6, dtype=torch.float32))
        assert (prio[4], prio[7], prio[9]) == (5.0, 4.0, 3.0)
