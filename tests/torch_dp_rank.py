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
- `tp_learner`: K learner steps of a tensor-parallel learner on the
  spec's mesh (`mesh`: MeshConfig fields), on the rank's dp rows, once
  per entry of `dropout` (False: the transformer's dropout rate set to
  0, as the frameworks draw their masks from different generators); the
  whole state (`get_state`), the rank's shards, metrics, TD errors, the
  digest and the net's module after `sync_to_network`.
- `sp_attention`: ring and Ulysses on the rank's sequence shard of
  global (B, S, H, D) q, k, v, forward and the gradients of a given
  output gradient, and `make_sp_attention`'s function on the whole
  inputs.
- `sp_model`: the net with `make_sp_attention` in eval mode on a batch.
- `train`: `run_training` over the group with the spec's mesh (on
  `device`, default the CPU, over `backend`); the report, the rows
  of the ring's first add and the kernels' launch counts.
- `cli_train`: `cli train --distributed` in this process with the spec's
  `argv`, the rank's coordinator flags added; its exit code and the
  JSON report it prints. With `crash: {"rank": R, "after": N}` every
  producer thread of rank R raises in its chunk after the rank's
  producers played N chunks (a stream that cannot recover). With
  `slow: {"rank": R, "seconds": S}` rank R's loop thread sleeps S
  seconds in its second chunk, the chunk the auto-tune times.
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
from alphatriangle_tpu_torch.parallel.distributed import attach_groups, backend_name
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


def tp_learner(spec, mesh) -> dict:
    env, model, train, _ = _configs(spec)
    batches = [shard_batch(mesh, dict(b)) for b in np.load(spec["batches"], allow_pickle=True)["batches"]]
    out = {}
    for drop in spec["dropout"]:
        net = _net(spec, env, model)
        trainer = Trainer(net, train, mesh=mesh)
        if not drop:
            for m in trainer.model.modules():
                if hasattr(m, "dropout_rate"):
                    m.dropout_rate = 0.0
        results = trainer.train_steps(batches)
        state = trainer.get_state()
        version = trainer.sync_to_network()
        out["dropout" if drop else "no_dropout"] = {
            "state": state,
            "shards": {n: p.detach().clone() for n, p in trainer.model.named_parameters()},
            "synced": {k: v.clone() for k, v in net.model.state_dict().items()},
            "synced_version": version,
            "metrics": [m for m, _ in results],
            "td": [np.asarray(td) for _, td in results],
            "checksum": trainer.param_checksum(),
        }
    return out


def sp_attention(spec, mesh) -> dict:
    from alphatriangle_tpu_torch.parallel.ring_attention import (
        make_sp_attention,
        ring_attention,
        ulysses_attention,
    )

    arrays = np.load(spec["qkv"])
    full = {k: torch.from_numpy(arrays[k]) for k in ("q", "k", "v", "dout")}
    n, i = mesh.sp, mesh.sp_index
    out = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        q, k, v = (full[x].chunk(n, dim=1)[i].clone().requires_grad_(True) for x in ("q", "k", "v"))
        y = fn(q, k, v, mesh=mesh)
        y.backward(full["dout"].chunk(n, dim=1)[i])
        out[name] = {"out": y.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
        q, k, v = (full[x].clone().requires_grad_(True) for x in ("q", "k", "v"))
        y = make_sp_attention(mesh, name)(q, k, v)
        y.backward(full["dout"])
        out[f"{name}_fn"] = {"out": y.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    return out


def sp_model(spec, mesh) -> dict:
    from alphatriangle_tpu_torch.parallel.ring_attention import make_sp_attention

    env, model, _, _ = _configs(spec)
    out = {}
    for kind in ("ring", "ulysses"):
        net = NeuralNetwork(model, env, seed=0, device="cpu", attention_fn=make_sp_attention(mesh, kind))
        net.model.load_state_dict(torch.load(spec["state_dict"], weights_only=True))
        batch = np.load(spec["batch"])
        with torch.no_grad():
            policy, value = net.model(torch.from_numpy(batch["grid"]), torch.from_numpy(batch["other"]))
        out[kind] = {"policy": policy, "value": value}
    return out


def train(spec, rank: int, world: int) -> dict:
    from alphatriangle_tpu_torch.rl.buffer import ExperienceBuffer
    from alphatriangle_tpu_torch.training import runner

    env, model, train_cfg, mcts = _configs(spec)
    adds = []
    add_dense = ExperienceBuffer.add_dense

    def recording(self, *args, **kwargs):
        adds.append([np.array(a) for a in args] + [np.array(v) for v in kwargs.values()])
        return add_dense(self, *args, **kwargs)

    ExperienceBuffer.add_dense = recording
    from alphatriangle_tpu_torch.rl.self_play import SelfPlayEngine

    chunks = []
    play_chunk = SelfPlayEngine.play_chunk

    def counting(self, *args, **kwargs):
        chunks.append(1)
        return play_chunk(self, *args, **kwargs)

    SelfPlayEngine.play_chunk = counting
    loop = runner.run_training(
        train_config=train_cfg, env_config=env, model_config=model, mcts_config=mcts,
        persistence_config=tcfg.PersistenceConfig(**spec["persistence"]), device=spec.get("device", "cpu"),
        distributed_config=DistributedConfig(
            ENABLED=True, COORDINATOR_ADDRESS=f"file://{spec['store']}", NUM_PROCESSES=world,
            PROCESS_ID=rank, TIMEOUT_S=120.0, BACKEND=spec.get("backend", "auto"),
        ),
        mesh_config=MeshConfig(**spec["mesh"]),
    )
    from alphatriangle_tpu_torch.ops import KERNELS

    return {"report": loop.report(), "first_add": adds[0] if adds else None, "adds": len(adds),
            "chunks": len(chunks),
            "launches": {name: kern.launches for name, kern in KERNELS.items()}}


def cli_train(spec, rank: int, world: int) -> dict:
    import contextlib
    import io
    import threading
    import time

    from alphatriangle_tpu_torch import cli
    from alphatriangle_tpu_torch.rl.self_play import SelfPlayEngine

    crash = spec.get("crash")
    if crash is not None and crash["rank"] == rank:
        played = []
        play_chunk = SelfPlayEngine.play_chunk

        def failing(self, *args, **kwargs):
            if threading.current_thread().name.startswith("self-play-producer"):
                played.append(1)
                if len(played) > crash["after"]:
                    raise RuntimeError("injected producer fault")
            return play_chunk(self, *args, **kwargs)

        SelfPlayEngine.play_chunk = failing
    slow = spec.get("slow")
    if slow is not None and slow["rank"] == rank:
        timed = []
        play_chunk = SelfPlayEngine.play_chunk

        def slowed(self, *args, **kwargs):
            if threading.current_thread() is threading.main_thread():
                timed.append(1)
                if len(timed) == 2:
                    time.sleep(slow["seconds"])
            return play_chunk(self, *args, **kwargs)

        SelfPlayEngine.play_chunk = slowed
    argv = [*spec["argv"], "--distributed", "--coordinator", f"file://{spec['store']}",
            "--num-processes", str(world), "--process-id", str(rank)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return {"rc": rc, "report": json.loads(out.getvalue().strip().splitlines()[-1])}


def main() -> None:
    spec = json.loads(open(sys.argv[1]).read())
    rank = int(sys.argv[2])
    world = int(spec["world"])
    if spec["scenario"] == "train":
        out = train(spec, rank, world)
    elif spec["scenario"] == "cli_train":
        out = cli_train(spec, rank, world)
    else:
        initialize_distributed(
            DistributedConfig(
                ENABLED=True, COORDINATOR_ADDRESS=f"file://{spec['store']}", NUM_PROCESSES=world,
                PROCESS_ID=rank, TIMEOUT_S=120.0,
            ),
            device="cpu",
        )
        mesh = attach_groups(MeshConfig(**spec.get("mesh", {})).build_mesh(world, rank, backend_name()))
        scenarios = {"learner": learner, "megastep": megastep, "tp_learner": tp_learner,
                     "sp_attention": sp_attention, "sp_model": sp_model}
        out = scenarios[spec["scenario"]](spec, mesh)
    torch.save(out, f"{spec['out']}/rank{rank}.pt")


if __name__ == "__main__":
    main()
