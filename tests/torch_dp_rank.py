"""One rank of a CPU data-parallel run of the PyTorch port, for the
`tests/test_torch_parallel_*.py` parity tests.

    OMP_NUM_THREADS=1 python tests/torch_dp_rank.py SPEC.json RANK

The spec names the scenario, the configs (dumps of the port's config
dataclasses), the world size, a `FileStore` path and the input and
output files. The rank joins a gloo group over the store, runs the
scenario on its share (its rows of the batch, its lanes, its ring
shard) and writes its results with `torch.save` to `<out>/rank<R>.pt`.
It imports torch and the port only, never JAX: the parent test builds
the JAX reference from the same inputs.

Scenarios:
- `learner`: K learner steps on the rank's rows of each global batch;
  the parameters, running statistics, metrics and TD errors after it.
- `megastep`: a dp megastep's components built as `training/setup.py`
  builds them (lane-sharded engine, sharded ring, dp learner), the
  global warm-up rows striped into the shards, seeded priorities, one
  megastep; the shard's storage, the sampled slots, the IS weights,
  the parameters and the counters after it.
"""

import json
import sys

import numpy as np
import torch

from alphatriangle_tpu_torch import config as tcfg
from alphatriangle_tpu_torch.config.mesh_config import MeshConfig
from alphatriangle_tpu_torch.env import TriangleEnv
from alphatriangle_tpu_torch.features import FeatureExtractor
from alphatriangle_tpu_torch.nn import NeuralNetwork
from alphatriangle_tpu_torch.parallel import DistributedConfig, initialize_distributed, shard_batch
from alphatriangle_tpu_torch.parallel.distributed import backend_name
from alphatriangle_tpu_torch.rl.megastep import MegastepRunner
from alphatriangle_tpu_torch.rl.self_play import SelfPlayEngine
from alphatriangle_tpu_torch.rl.sharded_device_buffer import ShardedDeviceReplayBuffer
from alphatriangle_tpu_torch.rl.trainer import Trainer
from alphatriangle_tpu_torch.rng import Lanes


def _configs(spec):
    env = tcfg.EnvConfig(**spec["env"])
    model = tcfg.ModelConfig(**spec["model"])
    train = tcfg.TrainConfig(**spec["train"])
    mcts = tcfg.AlphaTriangleMCTSConfig(**spec["mcts"]) if "mcts" in spec else None
    return env, model, train, mcts


def _net(spec, env, model):
    net = NeuralNetwork(model, env, seed=0, device="cpu")
    net.model.load_state_dict(torch.load(spec["state_dict"], weights_only=True))
    return net


def learner(spec, mesh) -> dict:
    env, model, train, _ = _configs(spec)
    net = _net(spec, env, model)
    trainer = Trainer(net, train, mesh=mesh)
    batches = [shard_batch(mesh, dict(b)) for b in np.load(spec["batches"], allow_pickle=True)["batches"]]
    results = trainer.train_steps(batches)
    return {
        "state": {k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
        "metrics": [m for m, _ in results],
        "td": [np.asarray(td) for _, td in results],
        "checksum": trainer.param_checksum(),
    }


def megastep(spec, mesh) -> dict:
    env_cfg, model, train, mcts = _configs(spec)
    env = TriangleEnv(env_cfg, device="cpu")
    extractor = FeatureExtractor(env, model)
    net = _net(spec, env_cfg, model)
    trainer = Trainer(net, train, mesh=mesh)
    buf = ShardedDeviceReplayBuffer(
        train, grid_shape=(model.GRID_INPUT_CHANNELS, env_cfg.ROWS, env_cfg.COLS),
        other_dim=extractor.other_dim, action_dim=env_cfg.action_dim, device="cpu", mesh=mesh,
    )
    per = train.SELF_PLAY_BATCH_SIZE // mesh.dp
    lanes = Lanes(mesh.dp_index * per, (mesh.dp_index + 1) * per, train.SELF_PLAY_BATCH_SIZE)
    engine = SelfPlayEngine(env, extractor, net, mcts, train, seed=train.RANDOM_SEED + 1, lanes=lanes)
    runner = MegastepRunner(engine, trainer, buf, train)
    rows = dict(np.load(spec["rows"]))
    td = rows.pop("td")
    slots = buf.add_dense(**rows)
    buf.update_priorities(slots, td[buf._stripe(len(td))])
    runner.sync_priorities_from_host()
    recorded = {}
    normalize = buf.normalize_weights

    def recording(w):
        recorded["weights"] = normalize(w).clone()
        return recorded["weights"]

    buf.normalize_weights = recording
    watermark = runner._max_priority_watermark()
    results, count = runner.run_megastep(spec["moves"], spec["k"])
    return {
        "storage": {k: v[: buf.cap_local].clone() for k, v in buf.storage.items()},
        "idx": runner.last_idx,
        "global_idx": buf.global_indices(runner.last_idx),
        "weights": recorded["weights"].numpy(),
        "watermark": watermark,
        "count": count,
        "pos": buf._pos,
        "size": len(buf),
        "state": {k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
        "metrics": [m for m, _ in results],
        "checksum": trainer.param_checksum(),
        "episodes": engine._episodes_played,
    }


def main() -> None:
    spec = json.loads(open(sys.argv[1]).read())
    rank = int(sys.argv[2])
    world = int(spec["world"])
    initialize_distributed(
        DistributedConfig(
            ENABLED=True, COORDINATOR_ADDRESS=f"file://{spec['store']}", NUM_PROCESSES=world,
            PROCESS_ID=rank, TIMEOUT_S=120.0,
        ),
        device="cpu",
    )
    mesh = MeshConfig().build_mesh(world, rank, backend_name())
    out = {"learner": learner, "megastep": megastep}[spec["scenario"]](spec, mesh)
    torch.save(out, f"{spec['out']}/rank{rank}.pt")


if __name__ == "__main__":
    main()
