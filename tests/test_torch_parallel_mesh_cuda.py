"""The synchronous loop over the mesh's mdl and sp axes on the card: two
rank processes (`tests/torch_dp_rank.py`'s `train` scenario, which
calls `run_training(mesh_config=...)`) sharing the card over gloo, at a
cut width (64 lanes, batch 64, 4-move chunks, 2 learner steps an
iteration to 4 steps).

- (dp=1, mdl=2): the transformer sharded over the two ranks; the mdl
  line's first rank plays all 64 lanes and broadcasts each harvest;
- (dp=1, sp=2, ring) and (dp=1, sp=2, ulysses): the learner's attention
  sequence-sharded, each rank playing 32 lanes.

Each run must complete with the gathered-parameter digests equal on
both ranks after every iteration, the search kernels launched 16 + 2
times a searched move on a rank that plays (none on the mdl replica),
and no PER count (a mesh with mdl or sp replicas takes the host ring).

Marked `cuda`: skips without a card. The file imports no JAX, so on a
machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_mesh_cuda.py
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu_torch import config as tcfg  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
LANES, BATCH, MOVES, STEPS = 64, 64, 4, 4

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ranks run the search kernels")


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(tmp_path: Path, mesh: dict) -> list:
    train = tcfg.TrainConfig(
        RUN_NAME="mesh", AUTO_RESUME_LATEST=False, SELF_PLAY_BATCH_SIZE=LANES, BATCH_SIZE=BATCH,
        MIN_BUFFER_SIZE_TO_TRAIN=BATCH, BUFFER_CAPACITY=4096, ROLLOUT_CHUNK_MOVES=MOVES,
        LEARNER_STEPS_PER_ROLLOUT=2, MAX_TRAINING_STEPS=STEPS, RANDOM_SEED=0,
    )
    env = tcfg.EnvConfig()
    model = tcfg.ModelConfig(OTHER_NN_INPUT_FEATURES_DIM=tcfg.expected_other_features_dim(env))
    spec = {
        "scenario": "train", "mesh": mesh, "world": 2, "device": "cuda", "backend": "gloo",
        "store": str(tmp_path / "store"), "out": str(tmp_path),
        "env": env.model_dump(), "model": model.model_dump(),
        "mcts": tcfg.AlphaTriangleMCTSConfig().model_dump(), "train": train.model_dump(),
        "persistence": {"ROOT_DATA_DIR": str(tmp_path / "runs"), "RUN_NAME": "mesh"},
    }
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    env_vars = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dp_rank.py"),
                               str(tmp_path / "spec.json"), str(r)], cwd=ROOT, env=env_vars,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.mark.parametrize("mesh, lanes", [
    ({"MDL_SIZE": 2}, LANES),
    ({"SP_SIZE": 2, "SP_ATTENTION": "ring"}, LANES // 2),
    ({"SP_SIZE": 2, "SP_ATTENTION": "ulysses"}, LANES // 2),
], ids=["tp2", "sp2-ring", "sp2-ulysses"])
def test_two_ranks_share_the_card_on_the_mesh(card, tmp_path, mesh, lanes):
    r0, r1 = _ranks(tmp_path, mesh)
    d0, d1 = r0["report"]["dp"], r1["report"]["dp"]
    assert d0["param_checksums"] == d1["param_checksums"]
    assert len(d0["param_checksums"]) == r0["report"]["iterations"] > 0
    for r in (r0, r1):
        rep = r["report"]
        assert rep["status"] == "completed" and rep["steps"] == STEPS and rep["replay_ring"] == "host"
        assert rep["dp"]["backend"] == "gloo" and rep["dp"]["world"] == 2
        moves = rep["iterations"] * MOVES
        assert rep["lane_moves"] == lanes * moves
        searched = moves if rep["dp"]["index"]["mdl"] == 0 else 0
        assert r["launches"]["gather_rows"] == 16 * searched
        assert r["launches"]["backup_update"] == 2 * searched
        assert r["launches"]["per_sample"] == 0
