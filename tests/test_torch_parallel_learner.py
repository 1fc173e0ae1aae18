"""Parity of the port's data-parallel learner (`rl/trainer.py` over
`parallel/`) with the JAX learner.

Two gloo ranks (`tests/torch_dp_rank.py`, no JAX) each take K = 2
learner steps on their rows of two global batches of 16 (8 rows a rank,
the JAX dp learner's shards) from the same converted net; the parent
takes the JAX single-device steps on the whole batches, as
`tests/test_trainer.py::test_8dev_step_matches_single_device` holds its
8-device mesh to. Both ranks' parameters are bit for bit equal (the
gradient all-reduce agreed); against JAX they hold within rtol 2e-4,
atol 2e-5, apart from the entries whose gradient is rounding-sized
(`torch_parity.rounding_sized`: Adam moves those by ~lr in either sign,
so they are held to that bound), and the metrics within 1e-4 relative.
The entropy metric is a ratio of sums over the global batch. With batch
norm the ranks take the global batch's statistics (a group norm's are
per row), so the running statistics agree with JAX's too: the variances
within 1e-4 relative, the means also within 0.01 x 2 lr (the second
step's batch mean carries the first step's rounding-sized bias moves).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.rl.trainer import Trainer as JaxTrainer  # noqa: E402
from alphatriangle_tpu_torch.nn import flax_to_torch  # noqa: E402
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


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_two_rank_steps_match_jax_on_the_global_batch(tmp_path, tiny_env_config, norm):
    model_cfg = small_model_config(tiny_env_config, USE_TRANSFORMER=False, TRANSFORMER_LAYERS=0,
                                   NORM_TYPE=norm)
    jcfg = JaxTrainConfig(
        AUTO_RESUME_LATEST=False, RUN_NAME="dp_learner", BATCH_SIZE=16, BUFFER_CAPACITY=64,
        MIN_BUFFER_SIZE_TO_TRAIN=16, MAX_TRAINING_STEPS=50, RANDOM_SEED=7, LEARNING_RATE=LR,
        ENTROPY_BONUS_WEIGHT=0.01, GRADIENT_CLIP_VALUE=5.0,
    )
    jnet = JaxNetwork(model_cfg, tiny_env_config, seed=3)
    torch.save(converted_state_dict(jnet), tmp_path / "net.pt")
    batches = [_batch(tiny_env_config, model_cfg, 16, seed=s) for s in (1, 2)]
    np.savez(tmp_path / "batches.npz", batches=np.array(batches, dtype=object))
    procs, out = spawn_ranks(
        {
            "scenario": "learner",
            "env": tiny_env_config.model_dump(),
            "model": model_cfg.model_dump(),
            "train": torch_cfg(jcfg).model_dump(),
            "state_dict": str(tmp_path / "net.pt"),
            "batches": str(tmp_path / "batches.npz"),
        },
        tmp_path,
    )
    jt = JaxTrainer(jnet, jcfg)
    jres = jt.train_steps(batches)
    ranks = collect_ranks(procs, out)

    r0, r1 = ranks
    assert r0["checksum"] == r1["checksum"]
    for name, t in r0["state"].items():
        assert torch.equal(t, r1["state"][name]), name
    for m0, m1, (jm, jtd), td0, td1 in zip(r0["metrics"], r1["metrics"], jres, r0["td"], r1["td"]):
        assert m0 == m1
        for key in ("total_loss", "policy_loss", "value_loss", "entropy", "grad_norm"):
            np.testing.assert_allclose(m0[key], jm[key], rtol=METRIC_RTOL, err_msg=key)
        # Each rank's TD errors are its own rows of the global batch.
        np.testing.assert_allclose(np.concatenate([td0, td1]), jtd, rtol=METRIC_RTOL, atol=1e-6)
    rounding = rounding_sized(jax_adam_moments(jt.state.opt_state)[1])
    assert_params_within(r0["state"], jt.state.params, rounding, LR, 2)
    if norm == "batch":
        want = flax_to_torch({"batch_stats": jax.tree_util.tree_map(np.asarray, jt.state.batch_stats)})
        assert want
        for name, ref in want.items():
            # The second step's batch means carry the biases the first
            # step's Adam moved by up to lr in either sign (rounding-sized
            # gradients); the running mean takes 0.01 of them. Variances
            # do not see a bias.
            atol = 1e-6 + (0.01 * 2 * LR if name.endswith("running_mean") else 0.0)
            np.testing.assert_allclose(r0["state"][name].numpy(), ref.numpy(), rtol=1e-4, atol=atol,
                                       err_msg=name)
