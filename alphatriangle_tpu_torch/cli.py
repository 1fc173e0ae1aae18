"""Command line of the PyTorch port: counterpart of
`alphatriangle_tpu/cli.py`'s `serve`, `train`, `eval`, `league`, `fleet`,
`health`, `perf`, `analyze`, `supervise`, `doctor`, `trace`, `watch`,
`compare`, `slo`, `devices`, `tb` and `ml` subcommands.

    python -m alphatriangle_tpu_torch.cli serve [--slots 64] [--buckets CSV] [--sims 64]
        [--sessions 96] [--max-moves 200] [--seed 0] [--device cuda]
        [--state-dict PATH] [--gumbel] [--run-name NAME | --checkpoint STEP_DIR]
        [--root-dir DIR] [--reload-every N] [--duration SECONDS]

Serves simulated sessions through `PolicyService`: the default board and
net (an untrained net of seed 0, or a state dict written by
`torch.save(flax_to_torch(variables), PATH)`), or with `--run-name` /
`--checkpoint` a run's own `configs.json` (its board, net, NORM_TYPE and
INFERENCE_PRECISION) and its newest or the named checkpoint, restored
as `cli eval` restores it. With `--run-name`, every `--reload-every`
dispatches the run's newest committed checkpoint is polled and a new
step hot-swapped in. `--duration` serves waves of `--sessions` until
the budget elapses. `--gumbel` searches with `GumbelMCTS(exploit=True)`
and serves its selected actions. `--buckets 16,32,64` serves on a rung
ladder (`serving/buckets.py`): every rung is warmed first, the load
keeps up to the top rung's count of sessions live, and the service
walks between rungs with it. Prints one JSON report, the precision, the
ladder's rungs and switches and the reloaded steps included.

    python -m alphatriangle_tpu_torch.cli train [--preset N|PATH] [--dry-setup]
        [--gumbel] [--fast-sims S [--full-search-prob P]] [--no-tensorboard]
        [--async-rollouts [--workers N] [--replay-ratio R] | --fused-megastep]
        [--device-replay {auto,on,off}] [--max-steps N] [--self-play-batch B]
        [--batch-size B] [--buffer-capacity N] [--min-buffer N] [--no-per]
        [--rollout-chunk T] [--fused-learner-steps K] [--seed S] [--device cuda]
        [--run-name NAME] [--root-dir DIR] [--no-auto-resume]
        [--load-checkpoint STEP_DIR] [--load-buffer NPZ]
        [--checkpoint-freq N] [--keep-checkpoints K]
        [--no-telemetry] [--watchdog-deadline SECONDS] [--dispatch-min-deadline SECONDS]
        [--dispatch-watchdog-poll SECONDS]
        [--profile] [--log-level LEVEL]

Trains the default board and net, or a BASELINE preset's (`--preset
1..5`, `config/presets.py`, or a `tuned_preset.json`; the flags given
override its values), through `run_training`: the synchronous loop
without a mode flag, the overlapped loop (producer threads behind a
replay-ratio gate) with `--async-rollouts`, the fused megastep with
`--fused-megastep`. `--gumbel` selects the Gumbel root search,
`--fast-sims` playout-cap randomization. The device is `--device`, else
the CPU where the config's `DEVICE` is "cpu" (preset 1, the CPU smoke),
else CUDA. `--dry-setup` builds every component and exits 0. Metrics go
to `live_metrics.jsonl` in the run directory and, unless
`--no-tensorboard`, to TensorBoard where it is installed. The run lives in
`<root>/AlphaTriangleTPUTorch/runs/<run>` (root `./.alphatriangle_data`
unless `--root-dir`), checkpoints every `--checkpoint-freq` steps and
at the end, and resumes the newest checkpointed run under the root
unless `--no-auto-resume`. SIGTERM saves, spills and exits 114. The run
directory also gets the run's telemetry unless `--no-telemetry`: the
`health.json` heartbeat (stall deadline `--watchdog-deadline`), the
`metrics.jsonl` ledger (every metrics tick and one `kind:"util"` record
an iteration, with the MFU against the card's bf16 peak), the
`flight.jsonl` ring of every dispatch (a dispatch past max(
`--dispatch-min-deadline`, 10 x its expected wall) is a wedge: the run
writes `wedge_report.json` and exits 113), and the anomaly screen of
every learner step; with the device stat-packs on (the default), one
`kind:"device_stats"` ledger record an iteration. `--profile` adds the
loop's phase timers (`Profile/*_ms`, `profile_data/phase_timers.json`)
and a `torch.profiler` trace of iterations 1-2 in `profile_data/`.
`--no-per` samples the ring uniformly. A completed run of
a tuned preset ledgers a `tune_outcome` record. Prints one JSON report:
steps, losses, rows ingested, episodes, weight syncs, the achieved
replay ratio, timings, the save and restore times, the kernel launches
and the beacon writer's launches.

    python -m alphatriangle_tpu_torch.cli eval [--checkpoint STEP_DIR |
        --run-name NAME] [--vs-checkpoint STEP_DIR | --vs-run NAME]
        [--root-dir DIR] [--games 64] [--sims 64] [--max-moves 200]
        [--seed 0] [--device cuda] [--gumbel]

Arena evaluation (`--gumbel`: a `GumbelMCTS(exploit=True)` search and
its selected actions): greedy search from a checkpoint (a step directory, or
a run's newest) on the run's own configs (its NORM_TYPE and
INFERENCE_PRECISION included), played as paired games through
`PolicyService`, against a uniform-random baseline on the same hands,
and head to head against a second checkpoint when one is named. Prints
the JAX report's keys, plus the dispatch times and kernel launches.

    python -m alphatriangle_tpu_torch.cli league --pool-from RUN [--run-name NAME]
        [--root-dir DIR] [--steps N] [--mix RATIO] [--slots B] [--games G] [--sims S]
        [--max-moves N] [--reload-every STEPS] [--staleness-window RELOADS]
        [--promotion-games N] [--promotion-win-rate R] [--exploration-floor F]
        [--seed S] [--self-play-batch B] [--batch-size B] [--buffer-capacity N]
        [--min-buffer N] [--rollout-chunk T] [--checkpoint-freq N]
        [--device-replay {auto,on,off}] [--device cuda] [--no-telemetry]

The experience flywheel (`league/flywheel.py`): the synchronous loop,
whose iterations play a league round at the --mix rate, against a pool
seeded from --pool-from's checkpoints, on that run's board and net,
with a training run's telemetry and one `kind:"league"` ledger record a
round. Prints the JAX report's keys (`ledger`: the run's
`metrics.jsonl`), the loop's report and each round's record.

    python -m alphatriangle_tpu_torch.cli fleet [--replicas 2] [--slots 8]
        [--buckets CSV] [--sims 4] [--requests 32] [--concurrency 8]
        [--max-moves 12] [--device cuda] [--state-dict PATH] [--smoke]
        [--chaos-kill-after N] [--reload-after N] [routing, recovery and
        replica deadline flags: the JAX `cli fleet`'s]

The serve fleet (`serving/fleet.py`): N `PolicyService` replica
subprocesses on the card behind a least-queue-depth router with
health-gated admission, retry onto another replica, optional hedging
and bounded-queue shedding; a supervisor classifies each replica death
and respawns it (a serve wedge onto the ladder's lower rung). Every
decision lands in the run's `fleet.jsonl`. This parent imports neither
torch nor numpy: the card lives in the replicas, which get `--device`
and `--state-dict`; a `configs.json` in the run directory gives the
board and net. Drives a storm of episode requests, writes `fleet.prom`
and prints one JSON report (the JAX report's keys); `--smoke` exits 1
unless every request was completed or shed.

    python -m alphatriangle_tpu_torch.cli health [RUN] [--root-dir DIR]
        [--deadline SECONDS] [--probe]

A run's `health.json` with a staleness verdict: LIVE or STALLED, the
heartbeat's age, the learner step, episodes and rows, the buffer, the
stalls and the card's memory. Exit 0 live, 1 stalled or stale, 2 no
heartbeat. `--probe` prints one JSON line instead, exit 3 for a dispatch
past its deadline (the fleet's admission probe). RUN defaults to the
newest run under the root.

    python -m alphatriangle_tpu_torch.cli perf [RUN|DIR|metrics.jsonl]
        [--root-dir DIR] [--window N] [--json]

A summary of a run's metrics ledger: step time p50 / p95, learner
steps/s, games/h, moves/s, sims/s, the MFU against the device's bf16
peak, transfers, dispatches per iteration, memory, the throughput trend
and, from the flight ring, each program's dispatch p50 / p95; the
league's line for a league run; the search-health and PER / learner
lines of the run's `kind:"device_stats"` records. `--window` keeps the
newest N util records. Exit 0, or 2 without a ledger or util records.

    python -m alphatriangle_tpu_torch.cli analyze PROFILE_DIR [--top N]

A `cli train --profile` run's `profile_data/`: the phase timers' table,
then for each `*.pt.trace.json` the device time by kernel per device
and stream and the host time by op per thread, with counts and shares.
Exit 0, or 1 when the directory holds neither.

    python -m alphatriangle_tpu_torch.cli supervise --run-name NAME [--root-dir DIR]
        [--max-restarts 8] [--circuit-breaker 3] [--backoff-base 5] [--backoff-max 300]
        [--quarantine-after 2] -- train|league [FLAGS]

The self-healing parent of a training or league child
(`supervise/supervisor.py`): each death is classified with the doctor's
evidence and the recovery policy restarts the child from the run's
newest committed checkpoint after a backoff, with its overrides in the
child's environment (quarantines, the OOM ladder, `TELEMETRY__BEACONS`
after a wedge), or gives up. `--run-name` / `--root-dir` /
`--no-auto-resume` are added to the child's argv. Exit 0 when the child
completes, 115 when the policy gives up, the child's code after a
forwarded SIGTERM / SIGINT. Events go to the run's `supervisor.jsonl`.

    python -m alphatriangle_tpu_torch.cli doctor [RUN|DIR] [--root-dir DIR] [--json]

How a run ended, from its files: the verdict (clean, never-started,
compile-hung, dispatch-hung, host-stall, oom, preempted) with the program
a hung run died in and its last beacon, and the evidence; a fleet
parent's run directory from its `fleet.jsonl`. The exit code is the
verdict (0, 2-7).

    python -m alphatriangle_tpu_torch.cli trace [RUN] [--root-dir DIR] [--top N] [--fleet]
    python -m alphatriangle_tpu_torch.cli watch [--run-name NAME] [--root-dir DIR]
        [--interval 2] [--once]
    python -m alphatriangle_tpu_torch.cli compare A B [--root-dir DIR] [--threshold 0.1]
        [--metrics CSV] [--json]
    python -m alphatriangle_tpu_torch.cli slo [RUN|DIR] [--root-dir DIR] [--json]
        [--latency-threshold MS] [--window SECONDS:BURN ...] [--now EPOCH] [--prom]

`trace`: the run's `trace.json` spans per name (exit 1 without one);
`--fleet` merges a fleet parent's evidence into `trace_fleet.json` with
a flow arrow per routed request. `watch`: the live console of a run
(rates, losses, the replay ratio, the newest util record, the dispatch
in flight, the heartbeat; a fleet parent's routing and SLO lines).
`compare`: two runs' (or snapshots') aligned metrics, exit 0 parity, 1 a
regression past the threshold, 2 unreadable. `slo`: a fleet's error
budgets and burn rates, exit 0 within budget, 1 burning, 2 no data.

    python -m alphatriangle_tpu_torch.cli devices
    python -m alphatriangle_tpu_torch.cli tb|ml [--root-dir DIR] [--port N]

`devices` lists the CUDA devices (exit 1 without one); `tb` and `ml`
launch TensorBoard or the MLflow UI over the runs root, exit 1 when it
is not installed.

Every command but `serve`, `train`, `eval`, `league` and `devices`
imports neither torch nor numpy: they read files, and the supervisor's
and the fleet's parents outlive a wedged card.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def cmd_serve(args: argparse.Namespace) -> int:
    import torch

    from .config import AlphaTriangleMCTSConfig, PersistenceConfig, TrainConfig
    from .config.run_configs import load_run_configs_or_default
    from .device import resolve_device
    from .env import TriangleEnv
    from .features import FeatureExtractor
    from .mcts import BatchedMCTS, GumbelMCTS
    from .nn import NeuralNetwork
    from .rl import Trainer
    from .serving import PolicyService, run_simulated_load
    from .stats import CheckpointManager

    def say(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    device = resolve_device(args.device)
    persistence = PersistenceConfig(
        RUN_NAME=args.run_name or "serve",
        **({"ROOT_DATA_DIR": args.root_dir} if args.root_dir else {}),
    )
    # The served run's own configs.json (as `cli eval` resolves it), else
    # the defaults.
    if args.run_name:
        cfg_dir = persistence.get_run_base_dir()
    elif args.checkpoint:
        cfg_dir = Path(args.checkpoint).resolve().parent.parent
    else:
        cfg_dir = Path("/nonexistent")
    env_cfg, model_cfg = load_run_configs_or_default(cfg_dir)
    mcts_cfg = AlphaTriangleMCTSConfig(max_simulations=args.sims)
    env = TriangleEnv(env_cfg, device=device)
    extractor = FeatureExtractor(env, model_cfg)
    state_dict = None
    source = "untrained"
    if args.state_dict:
        state_dict = torch.load(args.state_dict, map_location="cpu", weights_only=True)
        source = args.state_dict
    net = NeuralNetwork(model_cfg, env_cfg, seed=0, state_dict=state_dict, device=device)
    trainer = mgr = None
    if args.checkpoint or args.run_name:
        trainer = Trainer(net, TrainConfig(RUN_NAME=persistence.RUN_NAME))
        mgr = CheckpointManager(persistence, device=device, create_dirs=False)
        loaded = mgr.restore_path(args.checkpoint) if args.checkpoint else mgr.restore()
        if loaded.train_state is None:
            say("serve: no checkpoint found; serving the untrained net")
        else:
            trainer.set_state(loaded.train_state)
            trainer.sync_to_network()
            source = f"step {loaded.global_step}"
    if args.gumbel:
        mcts = GumbelMCTS(env, extractor, net.model, mcts_cfg, net.support, exploit=True)
    else:
        mcts = BatchedMCTS(env, extractor, net.model, mcts_cfg, net.support)
    service = PolicyService(
        env, extractor, net, mcts, slots=args.slots, rng_seed=args.seed, ladder=args.buckets
    )
    ladder_note = f", ladder {','.join(map(str, service.ladder.rungs))}" if args.buckets else ""
    say(
        f"serve: {source} net, board {env_cfg.ROWS}x{env_cfg.COLS}, {args.slots} slots"
        f"{ladder_note}, {args.sims} sims/move{', gumbel' if args.gumbel else ''}, "
        f"{model_cfg.INFERENCE_PRECISION} weights, device {device}"
    )
    if args.buckets:
        # Every rung, before the load: a switch mid-stream then costs the
        # migration, not a cold width.
        t_warm = time.perf_counter()
        service.warm()
        say(f"serve: warmed rungs {list(service.ladder.rungs)} ({time.perf_counter() - t_warm:.1f}s)")

    # Hot reload: every --reload-every dispatches, poll the run's newest
    # committed checkpoint; a new step is restored and swapped in
    # between dispatches.
    served_step = {"step": mgr.latest_step() if mgr else None, "reloaded": []}

    def reload_hook(svc, dispatches: int) -> None:
        if mgr is None or not args.run_name or args.reload_every <= 0:
            return
        if dispatches % args.reload_every:
            return
        latest = mgr.latest_step()
        if latest is None or latest == served_step["step"]:
            return
        loaded = mgr.restore()
        if loaded.train_state is None:
            return
        trainer.set_state(loaded.train_state)
        trainer.sync_to_network()
        svc.reload_weights()
        served_step["step"] = latest
        served_step["reloaded"].append(latest)
        say(f"serve: hot-reloaded weights at checkpoint step {latest}")

    t0 = time.perf_counter()
    deadline = None if args.duration is None else time.monotonic() + args.duration
    waves = []
    while True:
        waves.append(run_simulated_load(
            service,
            total_sessions=args.sessions,
            # Under a ladder, demand up to the top rung walks it up.
            concurrency=service.max_slots if args.buckets else args.slots,
            max_moves=args.max_moves,
            seed=args.seed + len(waves),
            reload_hook=reload_hook,
            progress=say,
        ))
        if deadline is None or time.monotonic() >= deadline:
            break
    stats = waves[-1]
    report = {
        "source": source,
        "run_name": args.run_name,
        "device": str(device),
        "slots": args.slots,
        "buckets": list(service.ladder.rungs),
        "rung_switches": service.rung_switches,
        "sims": args.sims,
        "gumbel": args.gumbel,
        "inference_precision": model_cfg.INFERENCE_PRECISION,
        "norm_type": model_cfg.NORM_TYPE,
        "waves": len(waves),
        "reloaded_steps": served_step["reloaded"],
        "wall_seconds": time.perf_counter() - t0,
        **stats,
        "sessions_served": sum(w["sessions_served"] for w in waves),
        "moves_served": sum(w["moves_served"] for w in waves),
        **service.serve_stats(drain=False),
        "kernel_launches": _kernel_launches(),
    }
    print(json.dumps(report))
    return 0 if report["sessions_served"] >= args.sessions * len(waves) else 1


def merge_train_overrides(base_config, overrides: dict):
    """CLI overrides on top of a preset's TrainConfig, rebuilt through the
    constructor so the validators run; a new horizon drops the derived
    schedule lengths so they derive afresh."""
    from .config import TrainConfig

    base = base_config.model_dump()
    if "MAX_TRAINING_STEPS" in overrides:
        base.pop("LR_SCHEDULER_T_MAX", None)
        base.pop("PER_BETA_ANNEAL_STEPS", None)
    base.update(overrides)
    return TrainConfig(**base)


def cmd_train(args: argparse.Namespace) -> int:
    from .config import AlphaTriangleMCTSConfig, PersistenceConfig, TrainConfig
    from .training import EXIT_CODES, run_training, setup_training_components

    overrides = {}
    if args.fused_megastep:
        overrides["FUSED_MEGASTEP"] = True
    if args.async_rollouts:
        overrides["ASYNC_ROLLOUTS"] = True
    for flag, field in (
        ("seed", "RANDOM_SEED"),
        ("max_steps", "MAX_TRAINING_STEPS"),
        ("self_play_batch", "SELF_PLAY_BATCH_SIZE"),
        ("batch_size", "BATCH_SIZE"),
        ("buffer_capacity", "BUFFER_CAPACITY"),
        ("min_buffer", "MIN_BUFFER_SIZE_TO_TRAIN"),
        ("rollout_chunk", "ROLLOUT_CHUNK_MOVES"),
        ("fused_learner_steps", "FUSED_LEARNER_STEPS"),
        ("device_replay", "DEVICE_REPLAY"),
        ("workers", "NUM_SELF_PLAY_WORKERS"),
        ("replay_ratio", "REPLAY_RATIO"),
    ):
        value = getattr(args, flag)
        if value is not None:
            overrides[field] = value
    if args.run_name is not None:
        overrides["RUN_NAME"] = args.run_name
    if args.checkpoint_freq is not None:
        overrides["CHECKPOINT_SAVE_FREQ_STEPS"] = args.checkpoint_freq
    if args.no_auto_resume:
        overrides["AUTO_RESUME_LATEST"] = False
    if args.load_checkpoint is not None:
        overrides["LOAD_CHECKPOINT_PATH"] = args.load_checkpoint
    if args.load_buffer is not None:
        overrides["LOAD_BUFFER_PATH"] = args.load_buffer
    if args.no_per:
        overrides["USE_PER"] = False
    if args.profile:
        overrides["PROFILE_WORKERS"] = True
    telemetry_config = None
    t_kw: dict = {}
    if args.no_telemetry:
        t_kw["ENABLED"] = False
    for flag, field in (
        ("watchdog_deadline", "WATCHDOG_DEADLINE_S"),
        ("dispatch_min_deadline", "DISPATCH_MIN_DEADLINE_S"),
        ("dispatch_watchdog_poll", "DISPATCH_WATCHDOG_POLL_S"),
    ):
        if getattr(args, flag) is not None:
            t_kw[field] = getattr(args, flag)
    if t_kw:
        from .config import TelemetryConfig

        telemetry_config = TelemetryConfig(**t_kw)
    configs = {"env_config": None, "model_config": None, "mcts_config": None}
    preset = None
    tuned_payload = None
    if args.preset is not None:
        preset = str(args.preset)
        if preset.isdigit():
            from .config import baseline_preset

            bundle = baseline_preset(int(preset), run_name=args.run_name)
        else:
            from .config import load_tuned_preset

            try:
                bundle = load_tuned_preset(preset)
            except ValueError as exc:
                raise SystemExit(f"--preset: {exc}") from exc
            tuned_payload = bundle.get("tuned")
        configs = {
            "env_config": bundle["env"],
            "model_config": bundle["model"],
            "mcts_config": bundle["mcts"],
        }
        train_cfg = merge_train_overrides(bundle["train"], overrides)
    else:
        train_cfg = TrainConfig(**overrides)
    if args.fast_sims is not None or args.full_search_prob is not None or args.gumbel:
        mcts = configs["mcts_config"]
        mcts_kw = mcts.model_dump() if mcts is not None else {}
        if args.fast_sims is not None:
            mcts_kw["fast_simulations"] = args.fast_sims
        if args.full_search_prob is not None:
            mcts_kw["full_search_prob"] = args.full_search_prob
        if args.gumbel:
            mcts_kw["root_selection"] = "gumbel"
        if args.full_search_prob is not None and mcts_kw.get("fast_simulations") is None:
            raise SystemExit(
                "--full-search-prob has no effect without --fast-sims "
                "(playout cap randomization stays disabled)."
            )
        configs["mcts_config"] = AlphaTriangleMCTSConfig(**mcts_kw)
    # An explicit --device wins; otherwise a config pinned to the CPU
    # (preset 1, the CPU smoke) runs there, and anything else on CUDA.
    device = args.device
    if device is None:
        device = "cpu" if train_cfg.DEVICE == "cpu" else "cuda"
    persistence = {"RUN_NAME": train_cfg.RUN_NAME}
    if args.root_dir is not None:
        persistence["ROOT_DATA_DIR"] = args.root_dir
    if args.keep_checkpoints is not None:
        persistence["KEEP_LAST_CHECKPOINTS"] = args.keep_checkpoints
    persistence_config = PersistenceConfig(**persistence)
    if args.dry_setup:
        c = setup_training_components(
            train_cfg, persistence_config=persistence_config, device=device,
            use_tensorboard=not args.no_tensorboard, telemetry_config=telemetry_config, **configs,
        )
        c.stats.close()
        print(json.dumps({
            "dry_setup": True,
            "preset": preset,
            "run_dir": str(persistence_config.get_run_base_dir()),
            "device": str(c.device),
            "lanes": c.self_play.batch_size,
            "parameters": sum(p.numel() for p in c.net.model.parameters()),
            "stats_writers": c.stats.writers,
        }))
        return 0
    loop = run_training(
        train_cfg, persistence_config=persistence_config, device=device,
        use_tensorboard=not args.no_tensorboard, telemetry_config=telemetry_config,
        log_level=args.log_level, **configs,
    )
    rc = EXIT_CODES[loop.status]
    tune_outcome = None
    if rc == 0 and tuned_payload is not None:
        # The tuner's prediction beside what the run observed, in the
        # run's ledger (the record `cli tune --calibrate` reads).
        from .autotune import ledger_tune_outcome

        tune_outcome = ledger_tune_outcome(loop.c.persistence_config.get_run_base_dir(), tuned_payload)
    from .ops.beacon import KERNEL as beacon_kernel

    print(json.dumps({
        **loop.report(), "preset": preset, "tune_outcome": tune_outcome,
        "kernel_launches": _kernel_launches(), "beacon_launches": beacon_kernel.launches,
    }))
    return rc


def _kernel_launches() -> dict:
    from .ops import KERNELS

    return {name: kern.launches for name, kern in KERNELS.items()}


def cmd_eval(args: argparse.Namespace) -> int:
    """Greedy search from a checkpoint against uniform-random play on the
    same paired hands, and head to head against a second checkpoint."""
    from .arena import play, play_service, random_policy
    from .config import AlphaTriangleMCTSConfig, PersistenceConfig, TrainConfig
    from .config.run_configs import load_run_configs, load_run_configs_or_default
    from .device import resolve_device
    from .env import TriangleEnv
    from .features import FeatureExtractor
    from .mcts import BatchedMCTS, GumbelMCTS
    from .nn import NeuralNetwork
    from .rl import Trainer
    from .serving import PolicyService
    from .stats import CheckpointManager

    device = resolve_device(args.device)

    def persistence(run_name: str) -> PersistenceConfig:
        kw = {"RUN_NAME": run_name}
        if args.root_dir:
            kw["ROOT_DATA_DIR"] = args.root_dir
        return PersistenceConfig(**kw)

    def config_dir(checkpoint, run_name) -> Path:
        # A step directory sits at <run>/checkpoints/step_NNNNNNNN.
        if run_name:
            return persistence(run_name).get_run_base_dir()
        if checkpoint:
            return Path(checkpoint).resolve().parent.parent
        return Path("/nonexistent")

    env_cfg, model_cfg = load_run_configs_or_default(config_dir(args.checkpoint, args.run_name))
    mcts_cfg = AlphaTriangleMCTSConfig(max_simulations=args.sims)
    env = TriangleEnv(env_cfg, device=device)

    def restore_net(checkpoint, run_name, net_model_cfg):
        """A fresh net, restored from a step directory or a run's newest
        checkpoint when one is named; (net, source label)."""
        net = NeuralNetwork(net_model_cfg, env_cfg, seed=0, device=device)
        label = "untrained"
        if checkpoint or run_name:
            trainer = Trainer(net, TrainConfig(RUN_NAME=run_name or "eval"))
            mgr = CheckpointManager(persistence(run_name or "eval"), device=device, create_dirs=False)
            loaded = mgr.restore_path(checkpoint) if checkpoint else mgr.restore()
            if loaded.train_state is None:
                print("No checkpoint found; evaluating the untrained net.", file=sys.stderr)
            else:
                trainer.set_state(loaded.train_state)
                trainer.sync_to_network()
                label = f"step {loaded.global_step}"
                if run_name and not checkpoint:
                    label = f"{run_name} {label}"
        return net, label

    def serve_play(net, net_model_cfg):
        extractor = FeatureExtractor(env, net_model_cfg)
        if args.gumbel:
            # Exploit mode: the deterministic argmax of logits + sigma(q).
            mcts = GumbelMCTS(env, extractor, net.model, mcts_cfg, net.support, exploit=True)
        else:
            mcts = BatchedMCTS(env, extractor, net.model, mcts_cfg, net.support)
        service = PolicyService(env, extractor, net, mcts, slots=args.games)
        t0 = time.perf_counter()
        scores, lengths, done = play_service(service, args.games, args.max_moves, args.seed)
        return scores, lengths, done, time.perf_counter() - t0, service.serve_stats(drain=False)

    net, source = restore_net(args.checkpoint, args.run_name, model_cfg)
    print(
        f"Evaluating {source} net: {args.games} games, {args.sims} sims/move, device {device}...",
        file=sys.stderr,
    )
    scores, lengths, done, wall_s, stats = serve_play(net, model_cfg)
    r_scores, _, _ = play(
        env, random_policy(env, args.seed), args.games, args.max_moves, args.seed
    )
    # Both sides start from the same reset keys and see the same hands:
    # the comparison is paired.
    diffs = scores - r_scores
    report = {
        "source": source,
        "games": args.games,
        "sims": args.sims,
        "gumbel": args.gumbel,
        "mcts_mean_score": round(float(scores.mean()), 2),
        "mcts_max_score": round(float(scores.max()), 2),
        "mcts_mean_length": round(float(lengths.mean()), 1),
        "finished_fraction": round(float(done.mean()), 3),
        "random_mean_score": round(float(r_scores.mean()), 2),
        "score_vs_random": round(float(scores.mean() / max(r_scores.mean(), 1e-9)), 3),
        "paired_mean_diff": round(float(diffs.mean()), 3),
        "paired_win_rate": round(float((diffs > 0).mean() + 0.5 * (diffs == 0).mean()), 3),
        "inference_precision": model_cfg.INFERENCE_PRECISION,
        "norm_type": model_cfg.NORM_TYPE,
    }
    if args.vs_checkpoint or args.vs_run:
        model_cfg_b = model_cfg
        loaded_b = load_run_configs(config_dir(args.vs_checkpoint, args.vs_run))
        if loaded_b:
            if loaded_b["env"] != env_cfg:
                raise SystemExit(
                    "Head-to-head needs both runs on the same env config; the --vs side "
                    "trained on a different board."
                )
            model_cfg_b = loaded_b["model"]
        net_b, source_b = restore_net(args.vs_checkpoint, args.vs_run, model_cfg_b)
        b_scores, _, _, _, _ = serve_play(net_b, model_cfg_b)
        h2h = scores - b_scores
        report.update(
            {
                "vs_source": source_b,
                "vs_mean_score": round(float(b_scores.mean()), 2),
                "h2h_paired_mean_diff": round(float(h2h.mean()), 3),
                "h2h_win_rate": round(float((h2h > 0).mean() + 0.5 * (h2h == 0).mean()), 3),
            }
        )
    report.update(
        {
            "device": str(device),
            "max_moves": args.max_moves,
            "mcts_scores": scores.tolist(),
            "random_scores": r_scores.tolist(),
            "mcts_wall_s": wall_s,
            "games_per_s": args.games / wall_s,
            "dispatches": stats["serve_dispatches"],
            "dispatch_ms_p50": stats["serve_batch_ms_p50"],
            "kernel_launches": _kernel_launches(),
        }
    )
    print(json.dumps(report))
    return 0


def cmd_league(args: argparse.Namespace) -> int:
    """The experience flywheel: the learner trains while a `PolicyService`
    plays matchmade games against a pool of past checkpoints, the live
    side's served games flowing into the replay ring beside self-play at
    --mix. The pool is seeded from --pool-from's checkpoints and grows
    by the run's own promotions; board and net come from that run's
    configs.json, so its checkpoints load."""
    from .config import AlphaTriangleMCTSConfig, LeagueConfig, PersistenceConfig, TrainConfig
    from .config.run_configs import load_run_configs_or_default
    from .league import LEAGUE_FILENAME, LIVE_ID, LeaguePool
    from .league.flywheel import run_flywheel
    from .training import EXIT_CODES

    def persistence_for(run_name: str) -> PersistenceConfig:
        kw = {"RUN_NAME": run_name}
        if args.root_dir:
            kw["ROOT_DATA_DIR"] = args.root_dir
        return PersistenceConfig(**kw)

    # Auto-resume would point RUN_NAME at the newest checkpointed run,
    # usually the --pool-from source, and train into it.
    overrides: dict = {"AUTO_RESUME_LATEST": False}
    for flag, field in (
        ("run_name", "RUN_NAME"),
        ("seed", "RANDOM_SEED"),
        ("steps", "MAX_TRAINING_STEPS"),
        ("self_play_batch", "SELF_PLAY_BATCH_SIZE"),
        ("batch_size", "BATCH_SIZE"),
        ("buffer_capacity", "BUFFER_CAPACITY"),
        ("min_buffer", "MIN_BUFFER_SIZE_TO_TRAIN"),
        ("rollout_chunk", "ROLLOUT_CHUNK_MOVES"),
        ("checkpoint_freq", "CHECKPOINT_SAVE_FREQ_STEPS"),
        ("device_replay", "DEVICE_REPLAY"),
        ("max_moves", "MAX_EPISODE_MOVES"),
    ):
        value = getattr(args, flag)
        if value is not None:
            overrides[field] = value
    train_config = TrainConfig(**overrides)
    league_kw: dict = {}
    for flag, field in (
        ("slots", "LEAGUE_SLOTS"),
        ("games", "GAMES_PER_ROUND"),
        ("mix", "LEAGUE_MIX_RATIO"),
        ("max_moves", "MAX_GAME_MOVES"),
        ("reload_every", "RELOAD_EVERY_STEPS"),
        ("staleness_window", "STALENESS_WINDOW"),
        ("promotion_games", "PROMOTION_MIN_GAMES"),
        ("promotion_win_rate", "PROMOTION_WIN_RATE"),
        ("exploration_floor", "EXPLORATION_FLOOR"),
    ):
        value = getattr(args, flag)
        if value is not None:
            league_kw[field] = value
    league_config = LeagueConfig(**league_kw)
    env_config, model_config = load_run_configs_or_default(
        persistence_for(args.pool_from).get_run_base_dir()
    )
    mcts_config = AlphaTriangleMCTSConfig(max_simulations=args.sims) if args.sims is not None else None
    telemetry_config = None
    if args.no_telemetry:
        from .config import TelemetryConfig

        telemetry_config = TelemetryConfig(ENABLED=False)
    persistence_config = persistence_for(train_config.RUN_NAME)
    loop = run_flywheel(
        train_config=train_config,
        league_config=league_config,
        env_config=env_config,
        model_config=model_config,
        mcts_config=mcts_config,
        persistence_config=persistence_config,
        pool_from=args.pool_from,
        device=args.device,
        telemetry_config=telemetry_config,
    )
    code = 1 if loop is None else EXIT_CODES[loop.status]
    run_dir = persistence_config.get_run_base_dir()
    pool = LeaguePool(run_dir / LEAGUE_FILENAME)
    report = {
        "run": train_config.RUN_NAME,
        "pool_from": args.pool_from,
        "exit": code,
        "pool_size": len(pool),
        "promotions": pool.promotions,
        "live_elo": round(pool.rating(LIVE_ID), 2),
        "ratings": {m: round(pool.rating(m), 2) for m in pool.member_ids()},
        "league_jsonl": str(run_dir / LEAGUE_FILENAME),
        "ledger": str(run_dir / "metrics.jsonl"),
    }
    if loop is not None:
        report.update(loop.report())
        report["league_records"] = loop.round_records
    report["kernel_launches"] = _kernel_launches()
    print(json.dumps(report))
    return code


def cmd_fleet(args: argparse.Namespace) -> int:
    """The serve fleet: replica subprocesses behind the router, supervised
    respawn, a storm of episode requests, the SLO report. Imports neither
    torch nor numpy."""
    import threading

    from .config import PersistenceConfig
    from .serving.fleet import FleetSupervisor, run_fleet_load
    from .supervise.policy import RecoveryPolicy
    from .telemetry.ledger import read_ledger
    from .telemetry.perf import summarize_fleet
    from .telemetry.slo import FLEET_PROM_FILENAME, evaluate_slos, write_fleet_prometheus

    run_dir = PersistenceConfig(
        RUN_NAME=args.run_name, **({"ROOT_DATA_DIR": args.root_dir} if args.root_dir else {})
    ).get_run_base_dir()
    run_dir.mkdir(parents=True, exist_ok=True)

    def policy_factory() -> RecoveryPolicy:
        return RecoveryPolicy(
            max_restarts=args.max_restarts,
            circuit_breaker_deaths=args.circuit_breaker,
            backoff_base_s=args.backoff_base,
            backoff_max_s=args.backoff_max,
            quarantine_after=args.quarantine_after,
        )

    replica_extra = [
        "--health-interval", str(args.replica_health_interval),
        "--dispatch-min-deadline", str(args.replica_dispatch_min_deadline),
        "--dispatch-first-deadline", str(args.replica_dispatch_first_deadline),
        "--dispatch-watchdog-poll", str(args.replica_watchdog_poll),
        "--tick-every", str(args.tick_every),
        "--device", args.device,
    ]
    if args.buckets:
        # The replicas' micro-batchers walk the same rungs as quarantine.
        replica_extra += ["--buckets", args.buckets]
    if args.state_dict:
        replica_extra += ["--state-dict", str(Path(args.state_dict).resolve())]
    fleet = FleetSupervisor(
        run_dir,
        replicas=args.replicas,
        slots=args.slots,
        sims=args.sims,
        seed=args.seed,
        configs_dir=run_dir,
        ladder=args.buckets,
        replica_extra_argv=replica_extra,
        policy_factory=policy_factory,
        probe_deadline_s=args.probe_deadline,
        poll_s=args.poll,
        spawn_timeout_s=args.spawn_timeout,
    )
    router = fleet.build_router(
        timeout_s=args.timeout,
        retries=args.retries,
        backoff_base_s=args.route_backoff_base,
        backoff_max_s=args.route_backoff_max,
        hedge_after_s=args.hedge_after,
        max_inflight=args.max_queue,
    )

    chaos_lock = threading.Lock()
    state = {"killed": False, "reload": None}

    def on_complete(n: int) -> None:
        with chaos_lock:
            kill_now = args.chaos_kill_after > 0 and not state["killed"] and n >= args.chaos_kill_after
            if kill_now:
                state["killed"] = True
            reload_now = args.reload_after > 0 and state["reload"] is None and n >= args.reload_after
            if reload_now:
                state["reload"] = threading.Thread(
                    target=fleet.rolling_reload, name="fleet-reload", daemon=True
                )
        if kill_now:
            victim = fleet.kill_replica()
            print(f"fleet: chaos-killed {victim}", file=sys.stderr)
        if reload_now:
            state["reload"].start()

    print(
        f"fleet: {args.replicas} replicas x {args.slots} slots on {args.device}, "
        f"{args.requests} requests, run dir {run_dir}",
        file=sys.stderr,
    )
    try:
        fleet.start()
        storm = run_fleet_load(
            router,
            fleet,
            requests=args.requests,
            concurrency=args.concurrency,
            max_moves=args.max_moves,
            seed=args.seed,
            timeout_s=args.timeout,
            on_complete=on_complete,
        )
        if state["reload"] is not None:
            state["reload"].join(timeout=180.0)
        # Let pending respawn chains land on fleet.jsonl before the
        # report reads it.
        deadline = time.monotonic() + args.settle
        while time.monotonic() < deadline:
            if all(h.name in fleet.gaveup or h.routable for h in fleet.handles):
                break
            time.sleep(0.2)
    finally:
        fleet.stop()

    report = {
        "schema": "alphatriangle.fleet.v1",
        "run": args.run_name,
        "replicas": args.replicas,
        "slots": args.slots,
        **storm,
        "fleet": fleet.summary(),
        "ledger": str(run_dir / "fleet.jsonl"),
    }
    slo_report = evaluate_slos(run_dir)
    write_fleet_prometheus(
        run_dir / FLEET_PROM_FILENAME,
        summarize_fleet(read_ledger(run_dir / "fleet.jsonl")),
        slo_report,
        run_name=args.run_name,
    )
    report["slo"] = slo_report["status"]
    print(json.dumps(report))
    if args.smoke:
        accounted = (
            storm["completed"] + storm["shed"] == storm["terminal"]
            and storm["terminal"] == storm["requests"]
        )
        return 0 if storm["lost"] == 0 and storm["completed"] > 0 and accounted else 1
    return 0


def _resolve_run_dir(run_name: "str | None", root_dir: "str | None") -> "Path | None":
    """The run directory of a run name under the runs root; the newest
    (by modification time, `stats/watch.py` `find_latest_run_dir`) when
    the name is omitted. Imports no torch."""
    from .config import PersistenceConfig
    from .stats.watch import find_latest_run_dir

    persistence = PersistenceConfig(
        RUN_NAME=run_name or "latest", **({"ROOT_DATA_DIR": root_dir} if root_dir else {})
    )
    if run_name:
        return persistence.get_run_base_dir()
    run_dir = find_latest_run_dir(persistence.get_runs_root_dir())
    if run_dir is None:
        print(f"no runs under {persistence.get_runs_root_dir()}", file=sys.stderr)
    return run_dir


def cmd_health(args: argparse.Namespace) -> int:
    """A run's heartbeat with a staleness verdict. Exit 0 live, 1
    stalled or stale, 2 no heartbeat; `--probe`: one JSON line and the
    probe's code (3: a dispatch past its deadline)."""
    from .telemetry.health import health_verdict, probe_run, read_health

    run_dir = _resolve_run_dir(args.run, args.root_dir)
    if run_dir is None:
        return 2
    if args.probe:
        result = probe_run(run_dir, deadline_s=args.deadline)
        print(json.dumps(result))
        return int(result["code"])
    path = run_dir / "health.json"
    payload = read_health(path)
    if payload is None:
        print(f"no readable heartbeat at {path}", file=sys.stderr)
        return 2
    ok, age, reason = health_verdict(payload, deadline_s=args.deadline)
    print(f"run {payload.get('run') or run_dir.name}: {'LIVE' if ok else 'STALLED'} ({reason})")
    print(
        f"  heartbeat    {age:,.0f}s ago (pid {payload.get('pid')}, "
        f"uptime {payload.get('uptime_s', 0):,.0f}s)"
    )
    learner_age = payload.get("learner_age_s")
    rollout_age = payload.get("rollout_age_s")
    print(
        f"  learner      step {payload.get('learner_step', 0):,}"
        + (
            f", last step {learner_age:,.0f}s before the heartbeat"
            if learner_age is not None
            else " (no step yet)"
        )
    )
    print(
        f"  self-play    {payload.get('episodes_played', 0):,} episodes, "
        f"{payload.get('experiences_added', 0):,} experiences"
        + (f", last harvest {rollout_age:,.0f}s before the heartbeat" if rollout_age is not None else "")
    )
    print(
        f"  buffer       {payload.get('buffer_size', 0):,} | stalls "
        f"{payload.get('stall_count', 0)} | deadline {payload.get('watchdog_deadline_s')}s"
    )
    for mem in payload.get("device_memory") or []:
        in_use = mem.get("bytes_in_use") or 0
        limit = mem.get("bytes_limit") or 0
        peak = mem.get("peak_bytes_in_use") or 0
        pct = f" ({100.0 * in_use / limit:.0f}%)" if limit else ""
        print(
            f"  device {mem.get('device')} [{mem.get('kind')}]  {in_use / 2**30:.2f} GiB in use"
            + (f", peak {peak / 2**30:.2f} GiB" if peak else "")
            + (f" / {limit / 2**30:.2f} GiB{pct}" if limit else "")
        )
    return 0 if ok else 1


def _fmt_cell(value, spec: str = ",.2f", scale: float = 1.0, unit: str = "") -> str:
    if not isinstance(value, (int, float)):
        return "—"
    return f"{value * scale:{spec}}{unit}"


def cmd_perf(args: argparse.Namespace) -> int:
    """A run's ledger summarized: step time, MFU, throughput and its
    trend, each program's dispatch walls, the league, a fleet parent's
    `fleet.jsonl`. Exit 0, or 2 when the ledger is missing or holds no
    util records."""
    from .telemetry.device_stats import summarize_device_stats
    from .telemetry.flight import FLIGHT_FILENAME, read_flight, summarize_flight
    from .telemetry.ledger import read_ledger, resolve_ledger_path
    from .telemetry.perf import fold_league_and_fleet, summarize_utilization

    target = Path(args.run) if args.run else None
    if target is not None and target.exists():
        ledger = resolve_ledger_path(target)
    else:
        run_dir = _resolve_run_dir(args.run, args.root_dir)
        if run_dir is None:
            return 2
        ledger = resolve_ledger_path(run_dir)
    if ledger is None:
        print(f"no metrics ledger at {args.run or 'the newest run'}", file=sys.stderr)
        return 2
    records = read_ledger(ledger)
    summary = summarize_utilization(records, window=args.window)
    if summary is None:
        print(
            f"{ledger}: no utilization records (the run predates the ledger, or telemetry "
            "was disabled)",
            file=sys.stderr,
        )
        return 2
    programs = summarize_flight(read_flight(ledger.parent / FLIGHT_FILENAME))
    if programs:
        summary["programs"] = programs
    league, fleet = fold_league_and_fleet(summary, records, ledger)
    # The device stat-packs' kind:"device_stats" records: the ds_* fields
    # and the lines below (none without records).
    devstats = summarize_device_stats([r for r in records if r.get("kind") == "device_stats"])
    if devstats is not None:
        summary.update(devstats)
    if args.json:
        summary["source"] = str(ledger)
        print(json.dumps(summary))
        return 0
    peak = summary.get("peak_bf16_tflops")
    print(f"perf {ledger}")
    print(
        f"  window       {summary['ticks']} tick(s) ({summary['ticks_total']} on record),"
        f" steps {summary.get('first_step')}→{summary.get('last_step')},"
        f" {_fmt_cell(summary.get('wall_seconds'), ',.0f', 1, 's')} wall"
    )
    print(
        f"  device       {summary.get('device_kind') or '?'}"
        f"   peak bf16 {_fmt_cell(peak, ',.0f', 1, ' TFLOP/s') if peak else 'unknown'}"
        + (f" [{summary.get('peak_source')}]" if summary.get("peak_source") else "")
    )
    print(
        f"  learner      {_fmt_cell(summary.get('learner_steps_per_sec'))} steps/s"
        f"   step p50 {_fmt_cell(summary.get('step_time_ms_p50'), ',.1f', 1, 'ms')}"
        f"   p95 {_fmt_cell(summary.get('step_time_ms_p95'), ',.1f', 1, 'ms')}"
    )
    print(
        f"  self-play    {_fmt_cell(summary.get('games_per_hour'), ',.1f')} games/h"
        f"   {_fmt_cell(summary.get('moves_per_sec'), ',.1f')} moves/s"
        f"   {_fmt_cell(summary.get('sims_per_sec'), ',.0f')} sims/s"
    )
    print(
        f"  utilization  MFU {_fmt_cell(summary.get('mfu'), ',.2f', 100.0, '%')}"
        f" (max {_fmt_cell(summary.get('mfu_max'), ',.2f', 100.0, '%')})"
        f"   {_fmt_cell(summary.get('tflops_per_sec'))} TFLOP/s"
    )
    print(
        f"  transfers    h2d {_fmt_cell(summary.get('transfer_h2d_ms'), ',.1f', 1, 'ms')}"
        f"   d2h {_fmt_cell(summary.get('transfer_d2h_ms'), ',.1f', 1, 'ms')}"
        f"   buffer fill {_fmt_cell(summary.get('buffer_fill_last'), ',.2f', 100.0, '%')}"
        f"   dispatch/iter {_fmt_cell(summary.get('dispatches_per_iteration'), ',.1f')}"
    )
    if summary.get("mem_peak_bytes_in_use") is not None:
        print(
            f"  memory       peak {_fmt_cell(summary.get('mem_peak_bytes_in_use'), ',.2f', 2**-30, ' GiB')}"
            f"   in use {_fmt_cell(summary.get('mem_bytes_in_use_last'), ',.2f', 2**-30, ' GiB')}"
            f"   limit {_fmt_cell(summary.get('mem_bytes_limit'), ',.2f', 2**-30, ' GiB')}"
        )
    if summary.get("chip_idle_fraction") is not None:
        # The share of the ticks with no dispatch in flight: a dispatch
        # is in flight from its launches to its fetch, so not the card's
        # idle share.
        print(
            f"  in flight    none {_fmt_cell(summary.get('chip_idle_fraction'), ',.1f', 100.0, '%')}"
            f" of the ticks (max {_fmt_cell(summary.get('chip_idle_fraction_max'), ',.1f', 100.0, '%')})"
        )
    if devstats is not None:
        # Search health from the stat-packs: entropy and occupancy are
        # means over the records, |v|max and the occupancy max run-wide.
        print(
            f"  search       entropy {_fmt_cell(summary.get('ds_root_entropy'), ',.2f')}"
            f" (min {_fmt_cell(summary.get('ds_root_entropy_min'), ',.2f')})"
            f"   |v|max {_fmt_cell(summary.get('ds_value_abs_max'), ',.2f')}"
            f"   occupancy {_fmt_cell(summary.get('ds_tree_occupancy'), ',.0f', 100.0, '%')}"
            f" (max {_fmt_cell(summary.get('ds_tree_occupancy_max'), ',.0f', 100.0, '%')})"
            f"   reuse {_fmt_cell(summary.get('ds_reuse_frac'), ',.0f', 100.0, '%')}"
            f"   records {_fmt_cell(summary.get('ds_records'), ',.0f')}"
        )
        if summary.get("ds_grad_norm_max") is not None or summary.get("ds_priority_skew") is not None:
            print(
                f"  ingest/per   priority skew {_fmt_cell(summary.get('ds_priority_skew'), ',.1f')}"
                f"   IS w min {_fmt_cell(summary.get('ds_is_weight_min'), ',.3f')}"
                f"   grad max {_fmt_cell(summary.get('ds_grad_norm_max'), ',.2f')}"
                f"   update max {_fmt_cell(summary.get('ds_update_norm_max'), ',.3f')}"
            )
    if league is not None:
        print(
            f"  league       pool {_fmt_cell(summary.get('league_pool_size'), ',.0f')}"
            f"   rounds {_fmt_cell(summary.get('league_rounds'), ',.0f')}"
            f"   ingest {_fmt_cell(summary.get('league_ingested_moves_per_sec'), ',.1f')} moves/s"
            f" ({_fmt_cell(summary.get('league_moves_ingested'), ',.0f')} total)"
            f"   staleness {_fmt_cell(summary.get('league_mean_staleness'), ',.1f')}"
            f"   stale dropped {_fmt_cell(summary.get('league_stale_dropped'), ',.0f')}"
            f"   promotions {_fmt_cell(summary.get('league_promotions'), ',.0f')}"
            f"   live elo {_fmt_cell(summary.get('league_live_elo'), ',.1f')}"
        )
    if fleet is not None:
        # Latency is end to end as the router saw it, retries and hedges
        # included.
        print(
            f"  fleet        move p50 {_fmt_cell(summary.get('fleet_move_latency_ms_p50'), ',.1f', 1, 'ms')}"
            f"   p95 {_fmt_cell(summary.get('fleet_move_latency_ms_p95'), ',.1f', 1, 'ms')}"
            f"   {_fmt_cell(summary.get('fleet_requests_per_sec'), ',.1f')} req/s"
            f"   deaths {_fmt_cell(summary.get('fleet_deaths'), ',.0f')}"
            f"   respawns {_fmt_cell(summary.get('fleet_respawns'), ',.0f')}"
            f"   readmits {_fmt_cell(summary.get('fleet_readmissions'), ',.0f')}"
            f"   sheds {_fmt_cell(summary.get('fleet_sheds'), ',.0f')}"
            f"   lost {_fmt_cell(summary.get('fleet_lost'), ',.0f')}"
        )
    if programs:
        width = max(max(len(p["program"]) for p in programs), 7)
        print(f"  {'program':<{width}}  {'count':>6}  {'p50':>9}  {'p95':>9}  {'total':>9}  err")
        for p in programs:
            print(
                f"  {p['program']:<{width}}  {p['count']:>6}"
                f"  {_fmt_cell(p['wall_s_p50'], ',.1f', 1e3, 'ms'):>9}"
                f"  {_fmt_cell(p['wall_s_p95'], ',.1f', 1e3, 'ms'):>9}"
                f"  {_fmt_cell(p['wall_s_total'], ',.1f', 1, 's'):>9}  {p['errors']}"
            )
    print(
        f"  trend        {_fmt_cell(summary.get('throughput_trend'), '+,.1f', 100.0, '%')} "
        "(2nd-half vs 1st-half throughput)"
    )
    return 0


def cmd_analyze(args: argparse.Namespace) -> int:
    """The phase table and trace summaries of a profile directory (exit 0;
    1 when it holds neither). Imports no torch."""
    from .profiling import analyze_profile_dir

    return analyze_profile_dir(args.profile_dir, top=args.top)


def cmd_trace(args: argparse.Namespace) -> int:
    """A run's span trace (`trace.json`) summarized per span name, busiest
    first; `--fleet` fuses a fleet parent's evidence into one Perfetto
    timeline with a flow arrow per routed request (`telemetry/merge.py`).
    Exit 0, or 1 without a readable trace or fleet ledger. Imports no
    torch."""
    from .telemetry.tracer import summarize_trace_file

    run_dir = _resolve_run_dir(args.run, args.root_dir)
    if run_dir is None:
        return 1
    if args.fleet:
        from .telemetry.merge import merge_fleet_trace

        try:
            result = merge_fleet_trace(run_dir)
        except FileNotFoundError:
            print(f"no fleet evidence in {run_dir} (fleet.jsonl missing: not a fleet parent's run "
                  "directory?)", file=sys.stderr)
            return 1
        print(
            f"merged {result['events']:,} events from {result['processes']} process(es), "
            f"{result['replicas']} replica dir(s) -> {result['path']}"
        )
        print(
            f"  route spans {result['route_spans']:,}   flow arrows {result['flows']:,} over "
            f"{len(result['flow_trace_ids']):,} trace id(s)"
        )
        print(f"\nfull fleet timeline: load {result['path']} in https://ui.perfetto.dev or chrome://tracing")
        return 0
    path = run_dir / "trace.json"
    try:
        rows = summarize_trace_file(path, top=args.top)
    except (OSError, ValueError) as exc:
        print(f"no readable span trace at {path} ({exc})", file=sys.stderr)
        return 1
    if not rows:
        print(f"{path}: no complete spans recorded.")
        return 0
    width = max(max(len(r["name"]) for r in rows), 5)
    print(f"{'span':<{width}}  {'count':>7}  {'total s':>9}  {'mean ms':>9}  {'max ms':>9}  {'threads':>7}")
    for r in rows:
        print(
            f"{r['name']:<{width}}  {r['count']:>7d}  {r['total_ms'] / 1e3:>9.2f}  "
            f"{r['mean_ms']:>9.2f}  {r['max_ms']:>9.2f}  {r['threads']:>7d}"
        )
    print(f"\nfull timeline: load {path} in https://ui.perfetto.dev or chrome://tracing")
    return 0


def cmd_watch(args: argparse.Namespace) -> int:
    """The live-run console: tails a run's live_metrics.jsonl, ledger,
    flight ring, heartbeat and (a fleet parent's) fleet.jsonl, and redraws
    one frame every --interval seconds; `--once` prints one frame and
    exits 0. Imports no torch."""
    from .stats.watch import (
        FleetWatchState,
        WatchState,
        fleet_line,
        render_frame,
        tail_fleet,
        tail_flight,
        tail_ledger_utils,
        tail_live_metrics,
    )
    from .telemetry.flight import FLIGHT_FILENAME
    from .telemetry.health import read_health

    run_dir = _resolve_run_dir(args.run_name, args.root_dir)
    if run_dir is None:
        return 1
    live = run_dir / "live_metrics.jsonl"
    ledger = run_dir / "metrics.jsonl"
    flight = run_dir / FLIGHT_FILENAME
    fleet_ledger = run_dir / "fleet.jsonl"
    heartbeat = run_dir / "health.json"
    state = WatchState()
    fleet_state = FleetWatchState()
    offsets = [
        tail_live_metrics(live, state, 0),
        tail_ledger_utils(ledger, state, 0),
        tail_flight(flight, state, 0),
        tail_fleet(fleet_ledger, fleet_state, 0),
    ]

    def frame() -> str:
        """The standard frame; a fleet parent's run directory adds the
        routing line and the SLO roll-up under it."""
        text = render_frame(state, run_dir.name, health=read_health(heartbeat))
        fl = fleet_line(fleet_state)
        if fl is None:
            return text
        text += "\n" + fl
        try:
            from .telemetry.slo import evaluate_slos, slo_status_line

            text += "\n  " + slo_status_line(evaluate_slos(run_dir))
        except Exception:  # the SLO line must never kill the console
            pass
        return text

    if not live.exists() and not fleet_ledger.exists():
        print(f"waiting for {live} (run still starting?) — Ctrl-C to stop", file=sys.stderr)
    shown = frame()
    print(shown, flush=True)
    if args.once:
        return 0
    try:
        while True:
            time.sleep(args.interval)
            offsets = [
                tail_live_metrics(live, state, offsets[0]),
                tail_ledger_utils(ledger, state, offsets[1]),
                tail_flight(flight, state, offsets[2]),
                tail_fleet(fleet_ledger, fleet_state, offsets[3]),
            ]
            # Redraw in place: move up over the previous frame.
            height = shown.count("\n") + 1
            shown = frame()
            print(f"\x1b[{height}F\x1b[0J" + shown, flush=True)
    except KeyboardInterrupt:
        return 0


def cmd_compare(args: argparse.Namespace) -> int:
    """The aligned metrics of two runs (or a run and a `cli perf --json`
    or bench snapshot): exit 0 parity or better, 1 a metric regressed
    past --threshold, 2 a side unreadable or nothing aligned. Imports no
    torch."""
    from .telemetry.perf import compare_summaries, load_comparable

    a, label_a = load_comparable(args.run_a, args.root_dir)
    b, label_b = load_comparable(args.run_b, args.root_dir)
    for side, loaded, label in (("A", a, label_a), ("B", b, label_b)):
        if loaded is None:
            print(f"compare: side {side}: {label}", file=sys.stderr)
    if a is None or b is None:
        return 2
    metrics = tuple(m for m in args.metrics.split(",") if m) if args.metrics else None
    rows, regressions = compare_summaries(a, b, threshold=args.threshold, metrics=metrics)
    if not [r for r in rows if r[4] != "n/a"]:
        print("compare: no aligned metrics between the two sides", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps({
            "a": label_a,
            "b": label_b,
            "threshold": args.threshold,
            "rows": [
                {"metric": m, "a": va, "b": vb, "ratio": ratio, "status": status}
                for m, va, vb, ratio, status in rows
            ],
            "regressions": regressions,
        }))
        return 1 if regressions else 0
    print(f"compare  A = {label_a}")
    print(f"         B = {label_b}   (threshold {args.threshold:.0%})")
    width = max(len(r[0]) for r in rows)
    print(f"  {'metric':<{width}}  {'A':>12}  {'B':>12}  {'A/B':>7}  verdict")
    for metric, va, vb, ratio, status in rows:
        print(
            f"  {metric:<{width}}  {_fmt_cell(va, ',.3f'):>12}  {_fmt_cell(vb, ',.3f'):>12}  "
            f"{_fmt_cell(ratio, '.3f'):>7}  {status}"
        )
    if regressions:
        print(f"REGRESSION: {', '.join(regressions)} worse than baseline by more than {args.threshold:.0%}")
        return 1
    print("parity: no metric regressed past the threshold")
    return 0


def cmd_slo(args: argparse.Namespace) -> int:
    """A fleet run's SLO report (`telemetry/slo.py`): availability, p95
    move latency and dispatch success as error budgets with burn-rate
    alerts. The exit code is the alert state: 0 within budget, 1 burning,
    2 no data. Imports no torch."""
    from .telemetry.slo import (
        FLEET_PROM_FILENAME,
        SLO_EXIT_CODES,
        evaluate_slos,
        slo_status_line,
        write_fleet_prometheus,
    )

    target = Path(args.run) if args.run else None
    if target is not None and target.is_dir():
        run_dir = target
    else:
        run_dir = _resolve_run_dir(args.run, args.root_dir)
        if run_dir is None:
            return SLO_EXIT_CODES["no-data"]
    windows = None
    if args.window:
        try:
            windows = tuple((float(w.split(":")[0]), float(w.split(":")[1])) for w in args.window)
        except (ValueError, IndexError):
            print(f"bad --window {args.window!r}: want SECONDS:BURN (e.g. 300:14.4)", file=sys.stderr)
            return SLO_EXIT_CODES["no-data"]
    kw = {"windows": windows} if windows else {}
    report = evaluate_slos(run_dir, now=args.now, latency_threshold_ms=args.latency_threshold, **kw)
    if args.prom:
        from .telemetry.ledger import read_ledger
        from .telemetry.perf import summarize_fleet

        write_fleet_prometheus(
            run_dir / FLEET_PROM_FILENAME,
            summarize_fleet(read_ledger(run_dir / "fleet.jsonl")),
            report,
            run_name=run_dir.name,
        )
    if args.json:
        print(json.dumps(report))
        return int(report["exit_code"])
    print(f"slo {run_dir}")
    print(f"  {slo_status_line(report)}")
    for slo in report["slos"]:
        print(f"  {slo['name']:<18} objective {slo['objective']:.2%}  budget {slo['error_budget']:.2%}  "
              f"[{slo['status']}]")
        for w in slo["windows"]:
            flag = "  BURNING" if w["burning"] else ""
            print(
                f"    window {w['window_s']:>6g}s  total {w['total']:>10,.0f}  bad {w['bad']:>8,.0f}  "
                f"err {w['error_rate']:.4f}  burn x{w['burn_rate']:,.1f} "
                f"(alert at x{w['burn_threshold']:g}){flag}"
            )
    print(f"  status    {report['status']} (exit {report['exit_code']})")
    return int(report["exit_code"])


def cmd_doctor(args: argparse.Namespace) -> int:
    """How a run ended, from its files alone: the flight ring, the
    heartbeat, the wedge and preempt reports, the ledger's util records
    and the newest progress beacon; a fleet parent's run directory from
    its `fleet.jsonl` and the replicas' verdicts. The exit code is the
    verdict: 0 clean, 2 never-started, 3 compile-hung, 4 dispatch-hung,
    5 host-stall, 6 oom, 7 preempted. Imports no torch: it runs beside a
    wedged card."""
    from .telemetry.device_stats import describe_beacon, last_beacon
    from .telemetry.flight import (
        FLIGHT_FILENAME,
        PREEMPT_REPORT_FILENAME,
        WEDGE_REPORT_FILENAME,
        classify_run,
        read_flight,
        read_preempt_report,
        read_wedge_report,
    )
    from .telemetry.health import read_health
    from .telemetry.ledger import read_ledger, resolve_ledger_path

    target = Path(args.run) if args.run else None
    if target is not None and target.exists():
        run_dir = target if target.is_dir() else target.parent
    else:
        run_dir = _resolve_run_dir(args.run, args.root_dir)
        if run_dir is None:
            return 2
    if (run_dir / "fleet.jsonl").exists():
        # A fleet parent has no heartbeat of a learner and no dispatches
        # of its own: classify from its ledger and the replicas' deaths.
        from .serving.fleet import classify_fleet

        verdict = classify_fleet(run_dir)
        if args.json:
            verdict["run_dir"] = str(run_dir)
            print(json.dumps(verdict))
            return int(verdict["exit_code"])
        ev = verdict["evidence"]
        print(f"doctor {run_dir} (fleet parent)")
        print(
            f"  verdict   {verdict['verdict']}"
            + (f"  ({verdict['program']} [{verdict['family']}])" if verdict.get("program") else "")
        )
        if verdict.get("detail"):
            print(f"  detail    {verdict['detail']}")
        print(
            f"  evidence  {ev['fleet_events']} fleet events, {ev['deaths']} deaths, "
            f"{ev['respawns']} respawns, {ev['evictions']} evictions, {len(ev['gaveup'])} gave up"
            + (", fleet-stop" if ev["fleet_stop"] else ", NO fleet-stop")
            + (", storm summary" if ev.get("storm_summary") else "")
            + (
                f", {ev['unsealed_route_intents']} unsealed route intent(s)"
                if ev.get("unsealed_route_intents")
                else ""
            )
        )
        return int(verdict["exit_code"])
    ledger = resolve_ledger_path(run_dir)
    verdict = classify_run(
        read_flight(run_dir / FLIGHT_FILENAME),
        health=read_health(run_dir / "health.json"),
        utils=read_ledger(ledger, kinds={"util"}) if ledger else [],
        wedge=read_wedge_report(run_dir / WEDGE_REPORT_FILENAME),
        preempt=read_preempt_report(run_dir / PREEMPT_REPORT_FILENAME),
        beacon=last_beacon(run_dir),
    )
    if args.json:
        verdict["run_dir"] = str(run_dir)
        print(json.dumps(verdict))
        return int(verdict["exit_code"])
    ev = verdict["evidence"]
    print(f"doctor {run_dir}")
    print(
        f"  verdict   {verdict['verdict']}"
        + (f"  ({verdict['program']} [{verdict['family']}])" if verdict.get("program") else "")
    )
    if verdict.get("detail"):
        print(f"  detail    {verdict['detail']}")
    if verdict.get("last_beacon"):
        print(f"  beacon    {describe_beacon(verdict['last_beacon'])}")
    print(
        f"  evidence  {ev['intents']} intents, {ev['seals']} seals, {ev['unsealed']} unsealed"
        + (", wedge report" if ev["wedge_report"] else "")
        + (", preempt report" if ev.get("preempt_report") else "")
        + (", stalled heartbeat" if ev["stalled"] else "")
        + (f", mem {ev['mem_utilization']:.0%}" if isinstance(ev.get("mem_utilization"), float) else "")
    )
    return int(verdict["exit_code"])


def cmd_supervise(args: argparse.Namespace) -> int:
    """The self-healing parent of `cli train` / `cli league`: spawns the
    child, classifies each death with the doctor's evidence and applies
    the recovery policy (restart from the newest committed checkpoint
    after a backoff, degrade on OOM, quarantine a family that keeps
    wedging, give up past the budget). Exit 0 when the child completes,
    115 when the policy gives up, the child's own code after a forwarded
    SIGTERM / SIGINT. Events go to runs/<run>/supervisor.jsonl. Imports
    no torch: the parent outlives a wedged card."""
    from .supervise import RecoveryPolicy, Supervisor

    child = list(args.child or [])
    if child and child[0] == "--":
        child = child[1:]
    if not child:
        child = ["train"]
    if child[0] in ("train", "league"):
        # The restarted child must resume this run, not auto-resume into
        # whichever run is newest.
        if "--run-name" not in child:
            child += ["--run-name", args.run_name]
        if args.root_dir and "--root-dir" not in child:
            child += ["--root-dir", args.root_dir]
        if child[0] == "train" and "--no-auto-resume" not in child:
            child.append("--no-auto-resume")
    run_dir = _resolve_run_dir(args.run_name, args.root_dir)
    if run_dir is None:
        return 2
    policy = RecoveryPolicy(
        max_restarts=args.max_restarts,
        circuit_breaker_deaths=args.circuit_breaker,
        backoff_base_s=args.backoff_base,
        backoff_max_s=args.backoff_max,
        quarantine_after=args.quarantine_after,
    )
    argv = [sys.executable, "-m", "alphatriangle_tpu_torch.cli", *child]
    print(f"supervise: {run_dir}\n  child: {' '.join(child)}", flush=True)
    return Supervisor(argv, run_dir, policy=policy).run()


def cmd_devices(args: argparse.Namespace) -> int:
    """The CUDA devices torch sees: index, name, memory, compute
    capability and SMs, with the torch and CUDA versions. Exit 1, saying
    so on stderr, when there is none."""
    import torch

    versions = f"torch {torch.__version__}, CUDA {torch.version.cuda}"
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        print(f"no CUDA device ({versions})", file=sys.stderr)
        return 1
    print(f"{versions}: {count} CUDA device(s)")
    for i in range(count):
        props = torch.cuda.get_device_properties(i)
        print(
            f"  {i}: {props.name}  {props.total_memory / 2**30:.1f} GiB  "
            f"capability {props.major}.{props.minor}  {props.multi_processor_count} SMs"
        )
    return 0


def _launch_ui(tool: str, argv: list, module: "str | None" = None) -> int:
    """Run a dashboard in the foreground; exit 1 when it is not installed.
    `module` is the runnable module where it differs from the import name
    (TensorBoard's is `tensorboard.main`)."""
    import subprocess

    try:
        __import__(tool)
    except ImportError:
        print(f"{tool} is not installed in this environment. Install it to use this command.",
              file=sys.stderr)
        return 1
    cmd = [sys.executable, "-m", module or tool, *argv]
    print(f"Launching: {' '.join(cmd)} (Ctrl-C to stop)")
    try:
        return subprocess.call(cmd)
    except KeyboardInterrupt:
        return 0


def cmd_tb(args: argparse.Namespace) -> int:
    from .config import PersistenceConfig

    root = args.root_dir or PersistenceConfig().ROOT_DATA_DIR
    return _launch_ui("tensorboard", ["--logdir", root, "--port", str(args.port)], module="tensorboard.main")


def cmd_ml(args: argparse.Namespace) -> int:
    from .config import PersistenceConfig

    root = args.root_dir or PersistenceConfig().ROOT_DATA_DIR
    return _launch_ui("mlflow", ["ui", "--backend-store-uri", root, "--port", str(args.port)])


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="alphatriangle_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser(
        "serve",
        help="Policy-serving front end: continuous-batching service over the "
        "batched wave search, driven by simulated sessions.",
    )
    serve.add_argument("--slots", type=int, default=64, metavar="B",
                       help="Concurrent session slots = the search batch (default 64).")
    serve.add_argument("--buckets", default=None, metavar="RUNGS",
                       help="Serve-shape ladder as a CSV rung list (e.g. 16,64,256; "
                       "serving/buckets.py). The service walks between rungs with sustained "
                       "load; every rung is warmed before the load. Default: one rung at --slots.")
    serve.add_argument("--sims", type=int, default=64)
    serve.add_argument("--sessions", type=int, default=96, metavar="N",
                       help="Simulated sessions to serve end to end.")
    serve.add_argument("--max-moves", type=int, default=200)
    serve.add_argument("--seed", type=int, default=0)
    serve.add_argument("--device", default="cuda",
                       help="Torch device (default cuda; 'cpu' runs the plain versions).")
    serve.add_argument("--state-dict", default=None, metavar="PATH",
                       help="Weights from nn/convert.py saved with torch.save "
                       "(default: the untrained net of seed 0).")
    serve.add_argument("--gumbel", action="store_true",
                       help="Gumbel root search in exploit mode; serve its selected actions.")
    serve.add_argument("--run-name", default=None,
                       help="Serve this run's newest checkpoint on its own configs.json "
                       "(board, net, NORM_TYPE, INFERENCE_PRECISION).")
    serve.add_argument("--checkpoint", default=None, metavar="PATH",
                       help="Serve this step directory (checkpoints/step_NNNNNNNN).")
    serve.add_argument("--root-dir", default=None,
                       help="Runs root directory (default ./.alphatriangle_data).")
    serve.add_argument("--reload-every", type=int, default=32, metavar="DISPATCHES",
                       help="Poll the run's checkpoints for a hot weight reload every N "
                       "dispatches (0 disables; needs --run-name).")
    serve.add_argument("--duration", type=float, default=None, metavar="SECONDS",
                       help="Serve waves of --sessions sessions until this wall budget "
                       "elapses (default: one wave).")
    serve.set_defaults(fn=cmd_serve)

    train = sub.add_parser(
        "train",
        help="Self-play training of the default board and net: the synchronous loop "
        "(rollout chunk, ring fold, learner steps per iteration) unless a mode flag is given.",
    )
    train.add_argument("--preset", default=None, metavar="N|PATH",
                       help="BASELINE config 1..5 (config/presets.py) or a tuned_preset.json; "
                       "the flags below override its values.")
    train.add_argument("--dry-setup", action="store_true",
                       help="Build every training component, then exit 0 without training.")
    train.add_argument("--gumbel", action="store_true",
                       help="Gumbel root search with sequential halving instead of PUCT.")
    train.add_argument("--fast-sims", type=int, default=None, metavar="S",
                       help="Playout cap randomization: fast searches of S simulations, "
                       "which train no policy.")
    train.add_argument("--full-search-prob", type=float, default=None, metavar="P",
                       help="Probability of a full search per move under --fast-sims "
                       "(default 0.25).")
    train.add_argument("--no-tensorboard", action="store_true",
                       help="No TensorBoard writer (live_metrics.jsonl is always written).")
    train.add_argument("--max-steps", type=int, default=None)
    train.add_argument("--self-play-batch", type=int, default=None)
    train.add_argument("--batch-size", type=int, default=None)
    train.add_argument("--buffer-capacity", type=int, default=None)
    train.add_argument("--min-buffer", type=int, default=None)
    train.add_argument("--rollout-chunk", type=int, default=None)
    train.add_argument("--fused-learner-steps", type=int, default=None, metavar="K",
                       help="Learner steps per dispatched group (per megastep with "
                       "--fused-megastep).")
    train.add_argument("--async-rollouts", action="store_true",
                       help="Overlapped loop: producer threads + replay-ratio-gated learner.")
    train.add_argument("--device-replay", choices=["auto", "on", "off"], default=None,
                       help="Replay ring on the card (auto: on a CUDA device) or the host.")
    train.add_argument("--fused-megastep", action="store_true",
                       help="Fused megastep loop: rollout chunk + ring ingest + PER draw + "
                       "K learner steps per iteration.")
    train.add_argument("--workers", type=int, default=None, metavar="N",
                       help="Rollout streams in overlapped mode.")
    train.add_argument("--replay-ratio", type=float, default=None,
                       help="Overlapped mode: samples consumed per row produced.")
    train.add_argument("--seed", type=int, default=None, help="Random seed.")
    train.add_argument("--device", default=None,
                       help="Torch device (default: cpu where the config's DEVICE is 'cpu', "
                       "as preset 1's, else cuda; 'cpu' runs the plain versions).")
    train.add_argument("--run-name", default=None, help="Run directory name.")
    train.add_argument("--root-dir", default=None,
                       help="Runs root directory (default ./.alphatriangle_data).")
    train.add_argument("--no-auto-resume", action="store_true",
                       help="Start fresh instead of resuming the latest run.")
    train.add_argument("--load-checkpoint", default=None, metavar="PATH",
                       help="Restore this step directory (checkpoints/step_NNNNNNNN).")
    train.add_argument("--load-buffer", default=None, metavar="PATH",
                       help="Restore the replay ring from this buffer spill (.npz).")
    train.add_argument("--checkpoint-freq", type=int, default=None, metavar="N",
                       help="Save every N learner steps (CHECKPOINT_SAVE_FREQ_STEPS).")
    train.add_argument("--keep-checkpoints", type=int, default=None, metavar="K",
                       help="Retain the newest K checkpoints (KEEP_LAST_CHECKPOINTS; 0 keeps all).")
    train.add_argument("--no-per", action="store_true",
                       help="Sample the replay ring uniformly (USE_PER=False).")
    train.add_argument("--no-telemetry", action="store_true",
                       help="No run telemetry: no health.json heartbeat or stall watchdog, no "
                       "metrics.jsonl ledger, no flight.jsonl ring, no anomaly screen.")
    train.add_argument("--watchdog-deadline", type=float, default=None, metavar="SECONDS",
                       help="Stall watchdog deadline: no learner step and no rollout harvest for "
                       "this long dumps thread stacks and flags the heartbeat (default 300).")
    train.add_argument("--dispatch-min-deadline", type=float, default=None, metavar="SECONDS",
                       help="Dispatch watchdog floor: a dispatch in flight past max(this, 10 x its "
                       "expected wall) is a wedge; the run writes wedge_report.json and exits 113 "
                       "(default 60).")
    train.add_argument("--dispatch-watchdog-poll", type=float, default=None, metavar="SECONDS",
                       help="Dispatch watchdog poll interval (default 5).")
    train.add_argument("--profile", action="store_true",
                       help="Phase timers (Profile/*_ms, phase_timers.json) and a torch.profiler "
                       "trace of iterations 1-2 into runs/<run>/profile_data/.")
    train.add_argument("--log-level", default="INFO", choices=["DEBUG", "INFO", "WARNING", "ERROR"])
    train.set_defaults(fn=cmd_train)

    ev = sub.add_parser(
        "eval",
        help="Arena evaluation: greedy search from a checkpoint against uniform-random play "
        "on paired hands, or head to head against a second checkpoint.",
    )
    ev.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="A step directory (checkpoints/step_NNNNNNNN).")
    ev.add_argument("--run-name", default=None, help="Evaluate this run's newest checkpoint.")
    ev.add_argument("--vs-checkpoint", default=None, metavar="PATH",
                    help="Head-to-head opponent: a step directory.")
    ev.add_argument("--vs-run", default=None,
                    help="Head-to-head opponent: the newest checkpoint of this run.")
    ev.add_argument("--root-dir", default=None)
    ev.add_argument("--games", type=int, default=64)
    ev.add_argument("--sims", type=int, default=64)
    ev.add_argument("--max-moves", type=int, default=200)
    ev.add_argument("--seed", type=int, default=0)
    ev.add_argument("--gumbel", action="store_true",
                    help="Gumbel root search in exploit mode; play its selected actions.")
    ev.add_argument("--device", default="cuda",
                    help="Torch device (default cuda; 'cpu' runs the plain versions).")
    ev.set_defaults(fn=cmd_eval)

    league = sub.add_parser(
        "league",
        help="Experience flywheel: the learner plus matchmade league games through a "
        "PolicyService in one process, the served games flowing into the replay ring beside "
        "self-play.",
    )
    league.add_argument("--pool-from", required=True, metavar="RUN",
                        help="Seed the opponent pool from this run's checkpoints (its configs.json "
                        "also gives the board and net).")
    league.add_argument("--run-name", default=None)
    league.add_argument("--root-dir", default=None,
                        help="Runs root directory (default ./.alphatriangle_data).")
    league.add_argument("--steps", type=int, default=None, metavar="N",
                        help="MAX_TRAINING_STEPS for the learner.")
    league.add_argument("--mix", type=float, default=None, metavar="RATIO",
                        help="Fraction of iterations that play a league round instead of a "
                        "self-play chunk (default 0.25).")
    league.add_argument("--slots", type=int, default=None, metavar="B",
                        help="League service session slots.")
    league.add_argument("--games", type=int, default=None, metavar="G",
                        help="Games per side per matchmade pairing.")
    league.add_argument("--sims", type=int, default=None)
    league.add_argument("--max-moves", type=int, default=None)
    league.add_argument("--reload-every", type=int, default=None, metavar="STEPS",
                        help="Broadcast the learner's weights to the league service every N "
                        "learner steps (default 8).")
    league.add_argument("--staleness-window", type=int, default=None, metavar="RELOADS",
                        help="Drop harvested rows more than this many reloads behind "
                        "(default 4; negative disables).")
    league.add_argument("--promotion-games", type=int, default=None)
    league.add_argument("--promotion-win-rate", type=float, default=None)
    league.add_argument("--exploration-floor", type=float, default=None)
    league.add_argument("--seed", type=int, default=None)
    league.add_argument("--self-play-batch", type=int, default=None)
    league.add_argument("--batch-size", type=int, default=None)
    league.add_argument("--buffer-capacity", type=int, default=None)
    league.add_argument("--min-buffer", type=int, default=None)
    league.add_argument("--rollout-chunk", type=int, default=None)
    league.add_argument("--checkpoint-freq", type=int, default=None)
    league.add_argument("--device-replay", default=None, choices=["auto", "on", "off"])
    league.add_argument("--device", default="cuda",
                        help="Torch device (default cuda; 'cpu' runs the plain versions).")
    league.add_argument("--no-telemetry", action="store_true",
                        help="No run telemetry (heartbeat, ledger, flight ring, anomaly screen).")
    league.set_defaults(fn=cmd_league)

    fleet = sub.add_parser(
        "fleet",
        help="Serve fleet: N PolicyService replica subprocesses behind a health-gated "
        "least-queue-depth router with retry/hedge/shed, verdict-driven replica restarts and "
        "a crash-safe fleet.jsonl decision ledger. The parent imports no torch.",
    )
    fleet.add_argument("--run-name", default="fleet",
                       help="Fleet run dir name (replica run dirs nest inside; a configs.json "
                       "there supplies the board/net).")
    fleet.add_argument("--root-dir", default=None,
                       help="Runs root directory (default ./.alphatriangle_data).")
    fleet.add_argument("--replicas", type=int, default=2, metavar="N")
    fleet.add_argument("--slots", type=int, default=8, metavar="B",
                       help="Session slots per replica (a quarantined replica respawns onto "
                       "the next ladder rung down).")
    fleet.add_argument("--buckets", default=None, metavar="RUNGS",
                       help="Serve-shape ladder as a CSV rung list shared by every replica's "
                       "micro-batcher and the quarantine walk-down. Default: the halving "
                       "ladder under --slots.")
    fleet.add_argument("--sims", type=int, default=4)
    fleet.add_argument("--seed", type=int, default=0)
    fleet.add_argument("--device", default="cuda",
                       help="Every replica's torch device (default cuda; 'cpu' runs the plain "
                       "versions).")
    fleet.add_argument("--state-dict", default=None, metavar="PATH",
                       help="Weights every replica serves, from nn/convert.py saved with "
                       "torch.save (default: the untrained net of seed 0).")
    fleet.add_argument("--requests", type=int, default=32, metavar="N",
                       help="Episode requests in the storm.")
    fleet.add_argument("--concurrency", type=int, default=8)
    fleet.add_argument("--max-moves", type=int, default=12)
    fleet.add_argument("--timeout", type=float, default=30.0, metavar="SECONDS",
                       help="Per-attempt request timeout (a timed-out attempt retries on a "
                       "different replica).")
    fleet.add_argument("--retries", type=int, default=2,
                       help="Retry budget per request after the first attempt.")
    fleet.add_argument("--route-backoff-base", type=float, default=0.1, metavar="SECONDS")
    fleet.add_argument("--route-backoff-max", type=float, default=2.0, metavar="SECONDS")
    fleet.add_argument("--hedge-after", type=float, default=None, metavar="SECONDS",
                       help="Hedge a straggling request onto a second replica after this "
                       "long; first result wins (default: off).")
    fleet.add_argument("--max-queue", type=int, default=64, metavar="N",
                       help="Bounded admission: in-flight requests past this are shed with "
                       "rejection code 'queue-full'.")
    fleet.add_argument("--probe-deadline", type=float, default=10.0, metavar="SECONDS",
                       help="Heartbeat staleness deadline for the routability probe.")
    fleet.add_argument("--poll", type=float, default=0.25, metavar="SECONDS",
                       help="Fleet monitor poll cadence (deaths, probes, respawns).")
    fleet.add_argument("--spawn-timeout", type=float, default=300.0, metavar="SECONDS",
                       help="Budget for a replica to warm and report ready.")
    fleet.add_argument("--settle", type=float, default=30.0, metavar="SECONDS",
                       help="Post-storm wait for pending respawn/readmit chains to land on "
                       "fleet.jsonl.")
    fleet.add_argument("--max-restarts", type=int, default=8)
    fleet.add_argument("--circuit-breaker", type=int, default=3)
    fleet.add_argument("--backoff-base", type=float, default=5.0, metavar="SECONDS",
                       help="Replica restart backoff base (RecoveryPolicy).")
    fleet.add_argument("--backoff-max", type=float, default=300.0, metavar="SECONDS")
    fleet.add_argument("--quarantine-after", type=int, default=2, metavar="N",
                       help="Wedges on the serve family before the replica respawns onto "
                       "the lower rung (SERVE_SLOTS__scale).")
    fleet.add_argument("--tick-every", type=int, default=8)
    fleet.add_argument("--replica-health-interval", type=float, default=1.0)
    fleet.add_argument("--replica-dispatch-min-deadline", type=float, default=60.0)
    fleet.add_argument("--replica-dispatch-first-deadline", type=float, default=900.0)
    fleet.add_argument("--replica-watchdog-poll", type=float, default=5.0)
    fleet.add_argument("--chaos-kill-after", type=int, default=0, metavar="N",
                       help="SIGKILL one replica after N terminal requests (0 = off).")
    fleet.add_argument("--reload-after", type=int, default=0, metavar="N",
                       help="Start a rolling weight reload after N terminal requests "
                       "(0 = off).")
    fleet.add_argument("--smoke", action="store_true",
                       help="Exit 1 unless every request was completed or shed.")
    fleet.set_defaults(fn=cmd_fleet)

    health = sub.add_parser(
        "health",
        help="Heartbeat check: a run's health.json with a staleness verdict (exit 0 live / "
        "1 stalled / 2 missing). Imports no torch.",
    )
    health.add_argument("run", nargs="?", default=None, help="Run name (default: the newest).")
    health.add_argument("--root-dir", default=None,
                        help="Runs root directory (default ./.alphatriangle_data).")
    health.add_argument("--deadline", type=float, default=None, metavar="SECONDS",
                        help="Staleness deadline (default: the run's watchdog deadline).")
    health.add_argument("--probe", action="store_true",
                        help="One JSON line and the probe's exit code (0 live / 1 stalled / "
                        "2 missing / 3 a dispatch past its deadline).")
    health.set_defaults(fn=cmd_health)

    perf = sub.add_parser(
        "perf",
        help="Summary of a run's metrics ledger (step time p50/p95, MFU, throughput trend, "
        "dispatch walls per program). Imports no torch.",
    )
    perf.add_argument("run", nargs="?", default=None,
                      help="Run name, run directory or metrics.jsonl (default: the newest run).")
    perf.add_argument("--root-dir", default=None,
                      help="Runs root directory (default ./.alphatriangle_data).")
    perf.add_argument("--window", type=int, default=None, metavar="N",
                      help="Summarize only the newest N utilization records.")
    perf.add_argument("--json", action="store_true", help="The summary as one JSON line.")
    perf.set_defaults(fn=cmd_perf)

    an = sub.add_parser(
        "analyze",
        help="Summary of a profile run: the phase timers' table, then each torch.profiler "
        "trace's device time by kernel and stream and host time by thread. Imports no torch.",
    )
    an.add_argument("profile_dir", help="runs/<run>/profile_data directory.")
    an.add_argument("--top", type=int, default=20)
    an.set_defaults(fn=cmd_analyze)

    supervise = sub.add_parser(
        "supervise",
        help="Self-healing parent of train / league: restart a dead child from its newest "
        "committed checkpoint by the doctor's verdict (backoff, OOM degrade, family quarantine, "
        "circuit breaker); events in runs/<run>/supervisor.jsonl. Imports no torch.",
    )
    supervise.add_argument("--run-name", required=True,
                           help="Run directory to supervise (added to the child's argv when absent "
                           "there).")
    supervise.add_argument("--root-dir", default=None,
                           help="Runs root directory (default ./.alphatriangle_data).")
    supervise.add_argument("--max-restarts", type=int, default=8, metavar="N",
                           help="Restart budget before giving up (exit 115).")
    supervise.add_argument("--circuit-breaker", type=int, default=3, metavar="N",
                           help="Consecutive deaths without a new committed checkpoint that give up "
                           "(exit 115).")
    supervise.add_argument("--backoff-base", type=float, default=5.0, metavar="SECONDS")
    supervise.add_argument("--backoff-max", type=float, default=300.0, metavar="SECONDS")
    supervise.add_argument("--quarantine-after", type=int, default=2, metavar="N",
                           help="Wedges on one program family before its riskiest knob is "
                           "quarantined (megastep -> the synchronous loop, learner -> K=1, rollout "
                           "-> no producer threads).")
    supervise.add_argument("child", nargs=argparse.REMAINDER,
                           help="The child subcommand and its flags after '--' (default: train).")
    supervise.set_defaults(fn=cmd_supervise)

    doctor = sub.add_parser(
        "doctor",
        help="Postmortem of a run from its files (flight ring, heartbeat, wedge and preempt "
        "reports, ledger, beacons): names the program a dead run hung in; the exit code is the "
        "verdict. Imports no torch.",
    )
    doctor.add_argument("run", nargs="?", default=None,
                        help="Run name, run directory or flight.jsonl (default: the newest run).")
    doctor.add_argument("--root-dir", default=None,
                        help="Runs root directory (default ./.alphatriangle_data).")
    doctor.add_argument("--json", action="store_true", help="The verdict as one JSON line.")
    doctor.set_defaults(fn=cmd_doctor)

    trace = sub.add_parser(
        "trace",
        help="Summary of a run's span trace (trace.json, loadable in Perfetto); --fleet merges a "
        "fleet parent's evidence into one timeline. Imports no torch.",
    )
    trace.add_argument("run", nargs="?", default=None, help="Run name (default: the newest).")
    trace.add_argument("--root-dir", default=None,
                       help="Runs root directory (default ./.alphatriangle_data).")
    trace.add_argument("--top", type=int, default=20)
    trace.add_argument("--fleet", action="store_true",
                       help="Fuse a fleet parent's run directory (its route brackets, fleet.jsonl, "
                       "every replica's flight ring and trace.json, clock-aligned) into one "
                       "trace_fleet.json with a flow arrow per trace id.")
    trace.set_defaults(fn=cmd_trace)

    watch = sub.add_parser(
        "watch",
        help="Live console of a run (live_metrics.jsonl, ledger, flight ring, heartbeat; a fleet "
        "parent's routing and SLO lines). Imports no torch.",
    )
    watch.add_argument("--run-name", default=None, help="Default: the newest run.")
    watch.add_argument("--root-dir", default=None,
                       help="Runs root directory (default ./.alphatriangle_data).")
    watch.add_argument("--interval", type=float, default=2.0)
    watch.add_argument("--once", action="store_true", help="Render one frame and exit.")
    watch.set_defaults(fn=cmd_watch)

    comp = sub.add_parser(
        "compare",
        help="Aligned-metric regression report between two runs (or a run and a `perf --json` or "
        "bench snapshot); exit 0 parity, 1 regression, 2 unreadable. Imports no torch.",
    )
    comp.add_argument("run_a", help="Candidate: run name or directory, metrics.jsonl, or JSON.")
    comp.add_argument("run_b", help="Baseline: run name or directory, metrics.jsonl, or JSON.")
    comp.add_argument("--root-dir", default=None,
                      help="Runs root directory (default ./.alphatriangle_data).")
    comp.add_argument("--threshold", type=float, default=0.1, metavar="FRAC",
                      help="Fail when a metric is worse than the baseline by more than this "
                      "fraction (default 0.1).")
    comp.add_argument("--json", action="store_true", help="The report as one JSON line.")
    comp.add_argument("--metrics", default=None, metavar="M1[,M2...]",
                      help="Compare only these metrics (default: telemetry/perf.py "
                      "COMPARE_METRICS).")
    comp.set_defaults(fn=cmd_compare)

    slo = sub.add_parser(
        "slo",
        help="Fleet SLO report: error budgets and multi-window burn-rate alerts from the fleet's "
        "ledgers; exit 0 within budget, 1 burning, 2 no data. Imports no torch.",
    )
    slo.add_argument("run", nargs="?", default=None,
                     help="Run name or a fleet parent's run directory (default: the newest run).")
    slo.add_argument("--root-dir", default=None,
                     help="Runs root directory (default ./.alphatriangle_data).")
    slo.add_argument("--json", action="store_true", help="The whole report as one JSON line.")
    slo.add_argument("--latency-threshold", type=float, default=500.0,
                     help="p95 move-latency SLO threshold in ms (default 500).")
    slo.add_argument("--window", action="append", default=None, metavar="SECONDS:BURN",
                     help="Burn-rate windows (repeatable), e.g. 300:14.4 3600:6 (default: the "
                     "fast-page / slow-ticket pair).")
    slo.add_argument("--now", type=float, default=None,
                     help="Evaluate at this epoch time instead of the newest record's.")
    slo.add_argument("--prom", action="store_true", help="Also rewrite the fleet.prom textfile.")
    slo.set_defaults(fn=cmd_slo)

    devices = sub.add_parser("devices", help="The CUDA devices torch sees; exit 1 without one.")
    devices.set_defaults(fn=cmd_devices)

    tb = sub.add_parser("tb", help="Launch TensorBoard over the runs root (when installed).")
    tb.add_argument("--root-dir", default=None)
    tb.add_argument("--port", type=int, default=6006)
    tb.set_defaults(fn=cmd_tb)

    ml = sub.add_parser("ml", help="Launch the MLflow UI over the runs root (when installed).")
    ml.add_argument("--root-dir", default=None)
    ml.add_argument("--port", type=int, default=5000)
    ml.set_defaults(fn=cmd_ml)
    return parser


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
