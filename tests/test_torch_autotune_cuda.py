"""The tuner's oracle on the card: an out-of-memory candidate is a
verdict, and the card is released after it.

At a small net (the default board, one conv layer, no transformer; 16
simulations, 2-move chunks, K = 2) the real oracle measures B = 64 and
B = 2048 alone, then the search runs both under
`torch.cuda.set_per_process_memory_fraction` set halfway between their
budgets: B = 2048 runs out of memory (its row `over`, the program and
the error in its detail) and B = 64, measured next, fits with the
budget it had alone, within 2%. Every call leaves `memory_allocated`
where it found it. Marked `cuda`: skips without a card. The file imports
no JAX, so on a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_autotune_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu_torch.autotune import (  # noqa: E402
    STATUS_FIT,
    STATUS_OVER,
    Candidate,
    SearchSpace,
    default_oracle,
    materialize_candidate,
    run_search,
)
from alphatriangle_tpu_torch.config import (  # noqa: E402
    AlphaTriangleMCTSConfig,
    EnvConfig,
    ModelConfig,
    TrainConfig,
    expected_other_features_dim,
)

SMALL, LARGE = 64, 2048
CHUNK, K, CAPACITY = 2, 2, 4096

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the oracle runs the candidates' programs there")


def _world():
    env = EnvConfig()
    model = ModelConfig(
        CONV_FILTERS=[16], CONV_KERNEL_SIZES=[3], CONV_STRIDES=[1], NUM_RESIDUAL_BLOCKS=0,
        RESIDUAL_BLOCK_FILTERS=16, USE_TRANSFORMER=False, FC_DIMS_SHARED=[64],
        POLICY_HEAD_DIMS=[64], VALUE_HEAD_DIMS=[64],
        OTHER_NN_INPUT_FEATURES_DIM=expected_other_features_dim(env),
    )
    mcts = AlphaTriangleMCTSConfig(max_simulations=16, max_depth=4)
    train = TrainConfig(BATCH_SIZE=64, BUFFER_CAPACITY=CAPACITY, MIN_BUFFER_SIZE_TO_TRAIN=128,
                        SELF_PLAY_BATCH_SIZE=SMALL, ROLLOUT_CHUNK_MOVES=CHUNK, FUSED_LEARNER_STEPS=K,
                        RUN_NAME="tune_cuda")
    return env, model, mcts, train


def _alone(oracle, world, b: int) -> dict:
    env, model, mcts, train = world
    cand = Candidate(geometry="plan", sp_batch=b, capacity=CAPACITY, chunk=CHUNK, fused_k=K, dp=1)
    e, m, t = materialize_candidate(cand, env, model, train, "sync")
    fits, budget, records = oracle(cand, e, m, t, None)
    assert budget.get("oom") is None, budget
    return budget


def test_out_of_memory_is_over_and_the_next_candidate_measures_as_alone(card):
    world = _world()
    env, model, mcts, train = world
    oracle = default_oracle(mcts, "sync", device_replay=True, device="cuda")
    small, large = _alone(oracle, world, SMALL), _alone(oracle, world, LARGE)
    assert large["total_bytes"] > 4 * small["total_bytes"], (small, large)
    total = torch.cuda.mem_get_info()[1]
    limit = (small["total_bytes"] + large["total_bytes"]) / 2
    torch.cuda.set_per_process_memory_fraction(limit / total)
    try:
        result = run_search(
            SearchSpace(batches=[SMALL, LARGE], capacities=[CAPACITY], chunks=[CHUNK], fused_ks=[K]),
            env, model, mcts, train, float(total), mode="sync", oracle=oracle,
        )
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    rows = {r["sp_batch"]: r for r in result.rows}
    assert rows[LARGE]["status"] == STATUS_OVER, rows[LARGE]
    assert "out of memory in" in rows[LARGE]["detail"] and "OutOfMemoryError" in rows[LARGE]["detail"]
    assert rows[SMALL]["status"] == STATUS_FIT and result.oracle_calls == 2
    after = rows[SMALL]["budget_total_bytes"]
    assert abs(after - small["total_bytes"]) <= 0.02 * small["total_bytes"], (after, small)
    for call in oracle.calls:
        assert call["allocated_after"] == call["allocated_before"], call
    print(f"alone: B{SMALL} {small['total_bytes']} B, B{LARGE} {large['total_bytes']} B; limit "
          f"{int(limit)} B of {total}; after the out-of-memory B{LARGE}: B{SMALL} {after} B; "
          f"seconds {[round(c['seconds'], 2) for c in oracle.calls]}; allocated "
          f"{[(c['allocated_before'], c['allocated_after']) for c in oracle.calls]}")
