"""Warm start of a plan's hot programs (`cli warm`): counterpart of
`alphatriangle_tpu/warm.py` (`warm_bench_programs`).

The JAX package lowers and compiles a plan's programs ahead of time into
its executable cache, so a later process deserializes them instead of
compiling. The port compiles no program; what a first run pays for is
building the `csrc/` kernels with `nvcc` (`ops/_cuda.py`'s build cache,
kept across processes in its build directory), and on the card the
first run at a shape (cuBLAS / cuDNN algorithm choices, the caching
allocator's blocks). So `warm_bench_programs` builds every kernel from
the repository's sources (one `nvcc` each, up to `jobs` at a time, as
the JAX package compiles up to `jobs` programs at a time), then runs
each hot program of the plan once at its shapes, one after another on
the card, its outputs dropped:

- `search/b<B>`: one search over the plan's B lanes (the waves'
  `gather_rows` and `backup_update` kernels);
- `self_play_chunk/t<T>`: a self-play chunk of T moves;
- `learner_step/b<b>` and `learner_fused/k<K>`: one learner step and one
  group of K on a synthetic batch;
- with the device ring, `learner_from_ring/k<K>`: a group gathered from
  the ring; on the card, `megastep/t<T>_k<K>`: a fused megastep over a
  ring of the plan's capacity (its PER draw the `per_sample` kernel);
- `serve/b<B>`: a serve dispatch's search at the plan's slot count
  (`PolicyService.warm_rung`).

Each row reports its status ("ran", or the error) and its seconds; the
report carries the build cache's hits and misses (`compile_cache.py`).
`plan_programs` builds the components and the program list that `cli
fit` measures too (`telemetry/memory.estimate_fit`).
"""

import logging
import time

logger = logging.getLogger(__name__)


def synthetic_batch(plan, other_dim: int, rows: int, seed: int = 0) -> dict:
    """A host batch of `rows` rows at the plan's shapes: a 0/1 grid,
    uniform features, policy targets that sum to 1, values in [-1, 1],
    unit IS and policy weights."""
    import numpy as np

    gen = np.random.default_rng(seed)
    c, h, w = plan.model.GRID_INPUT_CHANNELS, plan.env.ROWS, plan.env.COLS
    policy = gen.random((rows, plan.env.action_dim), dtype=np.float32)
    return {
        "grid": (gen.random((rows, c, h, w)) < 0.5).astype(np.float32),
        "other_features": gen.random((rows, other_dim), dtype=np.float32),
        "policy_target": policy / policy.sum(axis=1, keepdims=True),
        "value_target": gen.uniform(-1.0, 1.0, rows).astype(np.float32),
        "weights": np.ones(rows, dtype=np.float32),
        "policy_weight": np.ones(rows, dtype=np.float32),
    }


def plan_programs(plan, device, serve: bool = True, megastep: bool = True) -> tuple:
    """Build the plan's components on `device` and list its hot programs.

    Returns (static records, programs): the learner state's and the
    ring's `kind: "memory"` records, and (label, run, argument bytes)
    per program, where `run()` runs it once and `argument bytes` are its
    resident inputs (the weights, the carried state, the ring). The
    megastep runs only on the card, as the JAX warm runs it only off the
    CPU; `serve` adds a serve dispatch at the plan's slot count."""
    import torch

    from . import rng
    from .device import resolve_device
    from .env import TriangleEnv
    from .features import FeatureExtractor
    from .nn import NeuralNetwork
    from .rl import SelfPlayEngine, Trainer
    from .rl.device_buffer import DeviceReplayBuffer
    from .telemetry.memory import replay_ring_bytes, replay_ring_record, train_state_record, tree_bytes

    device = resolve_device(device)
    env = TriangleEnv(plan.env, device=device)
    extractor = FeatureExtractor(env, plan.model)
    net = NeuralNetwork(plan.model, plan.env, seed=0, device=device)
    engine = SelfPlayEngine(env, extractor, net, plan.mcts, plan.train, seed=0)
    trainer = Trainer(net, plan.train)
    grid_shape = (plan.model.GRID_INPUT_CHANNELS, plan.env.ROWS, plan.env.COLS)
    weights = tree_bytes(list(net.model.parameters()))
    state = train_state_record(trainer)
    static = [state]
    ring = None
    if plan.device_replay:
        ring = DeviceReplayBuffer(plan.train, grid_shape=grid_shape, other_dim=extractor.other_dim,
                                  action_dim=plan.env.action_dim, device=device)
        static.append(ring.memory_record())
    else:
        static.append(replay_ring_record(
            replay_ring_bytes(plan.train.BUFFER_CAPACITY, grid_shape, extractor.other_dim,
                              plan.env.action_dim),
            plan.train.BUFFER_CAPACITY, location="host",
        ))
    batch = synthetic_batch(plan, extractor.other_dim, plan.lbatch)
    batch_bytes = sum(v.nbytes for v in batch.values())
    fill = max(plan.lbatch, plan.train.MIN_BUFFER_SIZE_TO_TRAIN)

    def filled(buffer):
        if len(buffer) < fill:
            rows = synthetic_batch(plan, extractor.other_dim, fill, seed=1)
            buffer.add_dense(rows["grid"], rows["other_features"], rows["policy_target"],
                             rows["value_target"], policy_weight=rows["policy_weight"])
        return buffer

    def search():
        lanes = plan.sp_batch
        states = env.reset(rng.split(rng.PRNGKey(0), lanes))
        engine.mcts.root_actions(engine.mcts.search(states, rng.PRNGKey(1)))

    def chunk():
        if ring is not None:
            engine.play_moves_device(plan.chunk)
        else:
            engine.play_moves(plan.chunk)

    programs = [
        (f"search/b{plan.sp_batch}", search, weights),
        (f"self_play_chunk/t{plan.chunk}", chunk, weights + tree_bytes(engine._carry)),
        (f"learner_step/b{plan.lbatch}", lambda: trainer.train_steps([batch]),
         state["total"] + batch_bytes),
        (f"learner_fused/k{plan.fused_k}", lambda: trainer.train_steps([batch] * plan.fused_k),
         state["total"] + plan.fused_k * batch_bytes),
    ]
    if ring is not None:
        def from_ring():
            filled(ring)
            samples = [ring.sample(plan.lbatch, current_train_step=trainer.global_step)
                       for _ in range(plan.fused_k)]
            trainer.train_steps_from(ring, samples)

        programs.append((f"learner_from_ring/k{plan.fused_k}", from_ring,
                         state["total"] + ring.storage_nbytes()))
    if megastep and device.type == "cuda":
        from .rl.megastep import MegastepRunner

        mega_train = plan.train.model_copy(update={"FUSED_MEGASTEP": True})
        mega_trainer = Trainer(net, mega_train)
        mega_ring = DeviceReplayBuffer(mega_train, grid_shape=grid_shape, other_dim=extractor.other_dim,
                                       action_dim=plan.env.action_dim, device=device)
        runner = MegastepRunner(engine, mega_trainer, mega_ring, mega_train)

        def mega():
            filled(mega_ring)
            runner.run_megastep(plan.chunk, plan.fused_k)

        programs.append((f"megastep/t{plan.chunk}_k{plan.fused_k}", mega,
                         state["total"] + mega_ring.storage_nbytes() + tree_bytes(engine._carry)))
    if serve:
        from .mcts import BatchedMCTS, GumbelMCTS
        from .serving import PolicyService

        gumbel = plan.mcts.root_selection == "gumbel"
        serve_mcts = (
            GumbelMCTS(env, extractor, net.model, plan.mcts, net.support, exploit=True)
            if gumbel else BatchedMCTS(env, extractor, net.model, plan.mcts, net.support)
        )
        service = PolicyService(env, extractor, net, serve_mcts, slots=plan.serve_batch)
        programs.append((f"serve/b{plan.serve_batch}", lambda: service.warm_rung(plan.serve_batch),
                         weights + tree_bytes(service.sessions.states)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return static, programs


def build_kernels(device, jobs: "int | None" = None) -> dict:
    """Build (or load from the build cache) every kernel of the package
    on the card, one `nvcc` per source, up to `jobs` at a time (all
    together without); returns the row of the report (nothing to build
    off the card)."""
    import torch

    if torch.device(device).type != "cuda":
        return {"program": "kernels", "status": "skipped-cpu", "seconds": 0.0}
    from .ops import KERNELS
    from .ops import beacon
    from .ops._cuda import build_all

    seconds = build_all([*KERNELS.values(), beacon.KERNEL], jobs=jobs)
    return {"program": "kernels", "status": "ran", "seconds": round(seconds, 1)}


def warm_bench_programs(
    plan, device, programs: "set[str] | None" = None, progress=None, jobs: int = 4
) -> dict:
    """Build the kernels, then run each of the plan's hot programs once.

    `programs`: optional substring filter on the labels (`cli warm
    --programs`). `progress`: optional callable(str) for a line a
    program. `jobs`: the kernels' `nvcc` builds at a time (`cli warm
    --jobs`). Returns {"programs": [rows], "stats": the build cache's
    stats, "seconds": total wall}."""
    from .compile_cache import get_build_cache

    def say(msg: str) -> None:
        logger.info(msg)
        if progress is not None:
            progress(msg)

    t_start = time.perf_counter()
    cache = get_build_cache()
    say(f"warm: device={device} scale={plan.scale} batch={plan.sp_batch} chunk={plan.chunk} "
        f"sims={plan.sims} cache={cache.cache_dir}")
    rows = [build_kernels(device, jobs)]
    say(f"warm: kernels: {rows[0]['status']} ({rows[0]['seconds']:.1f}s)")
    _, targets = plan_programs(plan, device)
    if programs:
        targets = [t for t in targets if any(p in t[0] for p in programs)]
    for name, run, _ in targets:
        t0 = time.perf_counter()
        try:
            run()
            _sync(device)
            status = "ran"
        except Exception as exc:  # a failed program must not stop the rest
            logger.exception("warm: %s failed", name)
            status = f"error: {type(exc).__name__}: {exc}"
        dt = time.perf_counter() - t0
        say(f"warm: {name}: {status} ({dt:.1f}s)")
        rows.append({"program": name, "status": status, "seconds": round(dt, 3)})
    stats = cache.stats()
    total = time.perf_counter() - t_start
    say(f"warm: done in {total:.1f}s, {stats['hits']} kernel(s) loaded from the build cache, "
        f"{stats['misses']} built")
    return {"programs": rows, "stats": stats, "seconds": round(total, 3)}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
