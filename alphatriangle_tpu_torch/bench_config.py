"""The plan of shapes `cli warm` and `cli fit` run: counterpart of
`alphatriangle_tpu/bench_config.py` (`BenchPlan`, `plan_from_tuned_preset`,
`resolve_bench_plan`).

One source of truth for a measurement configuration's shapes: the
configs, the lane, chunk and batch sizes, the fused K and the serve
slot count. Of the JAX package's environment knobs it honours the two
that the `warm` / `fit` targets map onto: BENCH_TUNED_PRESET (a
`tuned_preset.json` path) and BENCH_CONFIG (a BASELINE preset, 1..5);
`smoke` is the caller's (the `smoke` target or BENCH_SMOKE=1).
`backend` is the device type the plan runs on: "cuda" takes the
flagship scale (the JAX package's accelerator scale), "cpu" the reduced
one.
"""

import os
from dataclasses import dataclass


@dataclass
class BenchPlan:
    """Everything `cli warm` / `cli fit` need about one measurement config."""

    env: object
    model: object
    mcts: object
    train: object
    scale: str
    sims: int
    sp_batch: int
    chunk: int
    lbatch: int
    fused_k: int = 4
    device_replay: bool = False
    # Policy-service slot count (serving/service.py): the `serve/b<B>`
    # search width `cli warm` runs and `cli fit --serve` measures; the
    # self-play lane count.
    serve_batch: int = 0


def plan_from_tuned_preset(path: str, smoke: bool, backend: str) -> BenchPlan:
    """BenchPlan from a `tuned_preset.json` artifact (`cli tune` of the
    JAX package): `cli warm <path>` and `cli fit <path>` run the shapes
    the tuned run dispatches. Raises SystemExit on a schema mismatch or
    a garbled artifact."""
    from .config import load_tuned_preset

    try:
        bundle = load_tuned_preset(path)
    except ValueError as exc:
        raise SystemExit(str(exc)) from exc
    payload = bundle["tuned"]
    train_cfg = bundle["train"]
    device_replay = bool(
        train_cfg.FUSED_MEGASTEP
        or train_cfg.DEVICE_REPLAY == "on"
        or (train_cfg.DEVICE_REPLAY == "auto" and backend != "cpu" and not smoke)
    )
    return BenchPlan(
        env=bundle["env"],
        model=bundle["model"],
        mcts=bundle["mcts"],
        train=train_cfg,
        scale=f"tuned_{payload.get('scale', 'preset')}",
        sims=bundle["mcts"].max_simulations,
        sp_batch=train_cfg.SELF_PLAY_BATCH_SIZE,
        chunk=train_cfg.ROLLOUT_CHUNK_MOVES,
        lbatch=train_cfg.BATCH_SIZE,
        fused_k=train_cfg.FUSED_LEARNER_STEPS,
        device_replay=device_replay,
        serve_batch=train_cfg.SELF_PLAY_BATCH_SIZE,
    )


def resolve_bench_plan(smoke: bool, backend: str, environ=None) -> BenchPlan:
    """The measurement configs for this (backend, environment) pair.
    BENCH_TUNED_PRESET wins over BENCH_CONFIG: the plan then takes the
    tuned shapes verbatim."""
    env = os.environ if environ is None else environ
    tuned = env.get("BENCH_TUNED_PRESET")
    if tuned:
        return plan_from_tuned_preset(tuned, smoke, backend)
    from .config import (
        AlphaTriangleMCTSConfig,
        EnvConfig,
        ModelConfig,
        TrainConfig,
        expected_other_features_dim,
    )

    preset = env.get("BENCH_CONFIG")
    if preset:
        # One of the five BASELINE configs (config/presets.py), at a
        # bench horizon.
        from .config import baseline_preset

        bundle = baseline_preset(int(preset), run_name="bench")
        env_cfg, model_cfg, mcts_cfg = bundle["env"], bundle["model"], bundle["mcts"]
        train_updates = {
            "BUFFER_CAPACITY": 10_000,
            "MIN_BUFFER_SIZE_TO_TRAIN": 1_000,
            "MAX_TRAINING_STEPS": 1_000,
        }
        if backend == "cpu" or smoke:
            # Neither a CPU nor a smoke run can push the preset's full
            # lane count; keep the net/search knobs, shrink lanes.
            cap = 16 if smoke else 64
            train_updates["SELF_PLAY_BATCH_SIZE"] = min(cap, bundle["train"].SELF_PLAY_BATCH_SIZE)
            train_updates["ROLLOUT_CHUNK_MOVES"] = 4
        if backend == "cpu":
            model_cfg = model_cfg.model_copy(update={"COMPUTE_DTYPE": "float32"})
        # The JAX bench measures float32 inference unless asked; the
        # learner keeps its float32 parameters either way.
        model_cfg = model_cfg.model_copy(update={"INFERENCE_PRECISION": "float32"})
        # Rebuild via the constructor so validation + schedule-length
        # derivation run against the bench horizon.
        base_kw = bundle["train"].model_dump()
        base_kw.pop("LR_SCHEDULER_T_MAX", None)
        base_kw.pop("PER_BETA_ANNEAL_STEPS", None)
        base_kw.update(train_updates)
        train_cfg = TrainConfig(**base_kw)
        scale = f"baseline_config_{preset}"
        sims = mcts_cfg.max_simulations
    else:
        # Three scales: smoke (sanity), cpu (a CPU cannot push the
        # flagship load, so it runs a reduced config), flagship (the
        # card).
        if smoke:
            scale, sims, depth, sp_batch, chunk, lbatch = ("smoke", 8, 4, 16, 4, 32)
        elif backend == "cpu":
            scale, sims, depth, sp_batch, chunk, lbatch = ("cpu", 16, 8, 64, 4, 128)
        else:
            scale, sims, depth, sp_batch, chunk, lbatch = ("flagship", 64, 8, 512, 16, 256)
        env_cfg = EnvConfig()
        model_cfg = ModelConfig(
            OTHER_NN_INPUT_FEATURES_DIM=expected_other_features_dim(env_cfg),
            COMPUTE_DTYPE="float32" if backend == "cpu" else "bfloat16",
        )
        mcts_kw: dict = {}
        if scale == "flagship":
            # The flagship training recipe: Gumbel root + playout cap
            # randomization; the reduced scales take the reference's
            # PUCT search.
            mcts_kw = {
                "root_selection": "gumbel",
                "fast_simulations": max(1, sims // 4),
                "full_search_prob": 0.25,
            }
        mcts_cfg = AlphaTriangleMCTSConfig(max_simulations=sims, max_depth=depth, **mcts_kw)
        train_cfg = TrainConfig(
            SELF_PLAY_BATCH_SIZE=sp_batch,
            ROLLOUT_CHUNK_MOVES=chunk,
            BATCH_SIZE=lbatch,
            BUFFER_CAPACITY=10_000,
            MIN_BUFFER_SIZE_TO_TRAIN=1_000,
            MAX_TRAINING_STEPS=1_000,
            RUN_NAME="bench",
        )

    # Secondary shapes, as the JAX bench derives them: K small on
    # cpu/smoke, and the device-resident ring only off the CPU.
    return BenchPlan(
        env=env_cfg,
        model=model_cfg,
        mcts=mcts_cfg,
        train=train_cfg,
        scale=scale,
        sims=sims,
        sp_batch=train_cfg.SELF_PLAY_BATCH_SIZE,
        chunk=train_cfg.ROLLOUT_CHUNK_MOVES,
        lbatch=train_cfg.BATCH_SIZE,
        fused_k=4 if (smoke or backend == "cpu") else 16,
        device_replay=backend != "cpu" and not smoke,
        serve_batch=train_cfg.SELF_PLAY_BATCH_SIZE,
    )
