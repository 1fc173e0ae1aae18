"""The port's rematerialization (`ModelConfig.REMAT`) and sliced
attention (`nn/model.py`): both change memory, never values.

- REMAT: learner steps of a net with residual blocks and two
  transformer layers, dropout on, from the same weights and batches,
  with and without REMAT: losses, TD errors and parameters are equal
  bit for bit (the recomputation repeats the forward's ops and dropout
  masks), and the checkpointed blocks were recomputed.
- Attention in slices of the batch (`SCORE_BUDGET`) equals the whole
  batch at once, bit for bit, in float32 and bfloat16, with and without
  the attention-weight dropout.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork  # noqa: E402
from alphatriangle_tpu_torch.nn import model as model_mod  # noqa: E402
from alphatriangle_tpu_torch.rl import Trainer  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import CPU, dense_rows, small_model_config, torch_cfg  # noqa: E402


def _trainer(env_cfg, remat: bool, dtype: str) -> Trainer:
    model_cfg = small_model_config(
        env_cfg, TRANSFORMER_LAYERS=2, REMAT=remat, COMPUTE_DTYPE=dtype
    )
    net = NeuralNetwork(torch_cfg(model_cfg), torch_cfg(env_cfg), seed=3, device=CPU)
    cfg = JaxTrainConfig(
        AUTO_RESUME_LATEST=False, RUN_NAME="remat", BATCH_SIZE=8, BUFFER_CAPACITY=64,
        MIN_BUFFER_SIZE_TO_TRAIN=8, MAX_TRAINING_STEPS=10, RANDOM_SEED=7,
    )
    return Trainer(net, torch_cfg(cfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_steps_equal_plain_steps(tiny_env_config, monkeypatch, dtype):
    calls = []
    real = model_mod.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(model_mod, "checkpoint", counting)
    plain, remat = _trainer(tiny_env_config, False, dtype), _trainer(tiny_env_config, True, dtype)
    other_dim = plain.nn.model_config.OTHER_NN_INPUT_FEATURES_DIM
    grid_shape = (1, tiny_env_config.ROWS, tiny_env_config.COLS)
    batches = []
    for seed in range(3):
        rows = dense_rows(seed, 8, grid_shape, other_dim, tiny_env_config.action_dim)
        rows["weights"] = np.ones(8, np.float32)
        batches.append(rows)
    want = plain.train_steps(batches)
    assert not calls
    got = remat.train_steps(batches)
    # One residual block and two transformer layers per forward, 3 steps.
    assert len(calls) == 9
    for (m, td), (wm, wtd) in zip(got, want):
        for key in ("total_loss", "policy_loss", "value_loss", "entropy", "grad_norm"):
            assert m[key] == wm[key], key
        np.testing.assert_array_equal(td, wtd)
    for (name, p), q in zip(remat.model.named_parameters(), plain.model.parameters()):
        assert torch.equal(p, q), name
    # Inference never rematerializes.
    with torch.no_grad():
        remat.model(torch.zeros((2, *grid_shape)), torch.zeros((2, other_dim)))
    assert len(calls) == 9


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drop", [False, True])
def test_sliced_attention_equals_whole(monkeypatch, dtype, drop):
    attn = model_mod.MultiHeadDotProductAttention(12, 2, dtype)
    model_mod.init_parameters(attn, seed=1)
    x = torch.randn((9, 7, 12), generator=torch.Generator().manual_seed(0))

    def run():
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            return attn(x, dropout=(0.1, gen) if drop else None)

    whole = run()
    # 2 heads x 7 x 7 scores per sequence: slices of 2 sequences, the last of 1.
    monkeypatch.setattr(model_mod, "SCORE_BUDGET", 2 * 2 * 7 * 7)
    sliced = run()
    assert sliced.dtype == dtype and torch.equal(sliced, whole)
