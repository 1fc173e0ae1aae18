"""Command line of the PyTorch port: counterpart of
`alphatriangle_tpu/cli.py`'s `serve`, `train`, `eval`, `league`, `fleet`,
`health`, `perf`, `analyze`, `supervise`, `doctor`, `trace`, `watch`,
`compare`, `slo`, `warm`, `fit`, `mem`, `roofline`, `tune`, `play`, `devices`, `tb`,
`ml` and `lint` subcommands.

    python -m alphatriangle_tpu_torch.cli serve [--slots 64] [--buckets CSV] [--sims 64]
        [--sessions 96] [--max-moves 200] [--seed 0] [--device cuda]
        [--state-dict PATH] [--gumbel] [--run-name NAME | --checkpoint STEP_DIR]
        [--root-dir DIR] [--reload-every N] [--duration SECONDS]
        [--serve-run-name NAME] [--smoke] [--tick-every 8] [--limit-gb GIB]
        [--no-preflight] [--no-warm]

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
walks between rungs with it. The service writes its own telemetry
(heartbeat, `metrics.jsonl` ticked every `--tick-every` dispatches,
flight ring) into the run `--serve-run-name` (default `serve_<run-name>`,
or `serve`) under the served run's root; before the load it warms
every rung (unless `--no-warm`) and runs the memory pre-flight (unless
`--no-preflight`): each rung's dispatch run once, its allocator peak
measured, the worst rung against `--limit-gb` or the card, exit 1 over
it. `--smoke` serves one wave and exits 1 unless every session was
served and the ledger landed. Prints one JSON
report, the precision, the ladder's rungs and switches, the reloaded
steps, the pre-flight and the served dispatches' kernel launches
included.

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
        [--distributed [--coordinator HOST:PORT|file://PATH --num-processes N
         --process-id R] [--dist-backend {auto,nccl,gloo}]]

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
unless `--no-auto-resume`. SIGTERM saves, spills and exits 114.
`--distributed` trains one model over the ranks of a process group, one
rank per device (`parallel/`): the synchronous loop, the overlapped loop
(`--async-rollouts`, its beats in lockstep over the ranks) and the
megastep, each rank on its share of the lanes and of the batch, its
gradients all-reduced. Tensor and
sequence parallelism (the mesh's mdl and sp axes) are reached through
`run_training(mesh_config=...)`, as in JAX: no flag sets them. Ranks come
from torchrun (`torchrun --nproc-per-node 2 -m alphatriangle_tpu_torch.cli
train --distributed ...`) or from the explicit flags, one process each;
NCCL on CUDA, gloo on the CPU, and `--dist-backend gloo` for ranks that
share one card. Rank 0 writes the run directory; every rank prints its
report (its `dp` block: rank, world, backend, parameter digests). The run
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
and a `torch.profiler` trace of iterations 1-2 (a megastep run's
megasteps 1-2) in `profile_data/`.
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

    python -m alphatriangle_tpu_torch.cli warm [TARGET] [--jobs N] [--programs S,...] [--device cuda]
    python -m alphatriangle_tpu_torch.cli fit [TARGET] [--limit-gb GIB] [--serve]
        [--programs S,...] [--json] [--device cuda]
    python -m alphatriangle_tpu_torch.cli mem|roofline [RUN|DIR|metrics.jsonl]
        [--root-dir DIR] [--json]

`warm` builds every kernel (or loads it from the build cache; `--jobs`
nvcc builds at a time, default 4) and runs
each hot program of a plan once at its shapes (`warm.py`; TARGET: auto,
the device's scale, smoke, cpu, 1..5 or a tuned_preset.json,
`bench_config.py`); exit 0 when every program ran. `fit` composes the
plan's per-device memory budget from the learner state, the ring and
each program's allocator peak over one run of it, against the card's
memory, `--limit-gb` or ALPHATRIANGLE_DEVICE_BYTES_LIMIT: exit 0 fits,
1 over (or out of memory in a measured run), 2 no limit known. `mem`
prints a run's memory-attribution table, `roofline` each dispatched
program's analytic intensity against the card's balance and the gaps
between dispatches; exit 2 without records.

    python -m alphatriangle_tpu_torch.cli tune [TARGET] [--limit-gb GIB] [--smoke] [--json]
        [--out PATH] [--run-name NAME] [--root-dir DIR] [--batches CSV] [--capacities CSV]
        [--chunks CSV] [--fused-k CSV] [--dp CSV] [--geometries CSV] [--kernel-backends CSV]
        [--precisions CSV] [--serve-buckets RUNGS ...] [--tree-reuse CSV]
        [--calibrate RUN_OR_JSON ...] [--mode {auto,sync,megastep}] [--device {auto,cuda,cpu}]

`tune` searches the (lanes, capacity, chunk, K, dp, geometry) space
around a plan (TARGET as `warm`'s) for the candidate of highest
predicted games/h that fits the byte limit (`autotune/`): gates and ring
arithmetic first, then B descending within each group, each candidate
left measured by `estimate_fit`, which runs its chunk, learner group and
(megastep mode) megastep once on the device and reads the allocator's
peak; the JAX oracle only compiles them. `--calibrate` folds earlier
runs' MFU, flight rings, cost records and `tune_outcome` records into
the model. It writes `runs/<run>/tuned_preset.json` for `train
--preset`. Exit 0 a winner, 1 none fits, 2 no byte limit known. The
device is `--device` (auto = the card), else the CPU for the `cpu`
target, else CUDA; asked for CUDA without a card it fails.

    python -m alphatriangle_tpu_torch.cli play [--seed 0] [--engine {auto,native,jax}]
        [--script "SLOT ROW COL;..."] [--device cuda]

`play` is interactive text play on the default board: the native host
engine (`env/native/`, built with g++ at first use), or with `--engine
jax` the port's `GameState` engine on `--device` (default the card; the
name is the JAX command line's). `--script` plays the given moves, then
exits.

    python -m alphatriangle_tpu_torch.cli lint [PATH] [--rule NAME]... [--baseline PATH]
        [--write-baseline] [--json]

`lint` runs graftlint (`analysis/`) over the port's package (or PATH):
the JAX package's seven rules, under their names and pragma (`#
graftlint: allow(rule) reason`), each restated for eager PyTorch. Its
baseline is the port's own `lint_baseline.json` inside the linted tree
(the repository root's holds the JAX package's keys). `--json` prints a
one-line verdict that leads with `"schema": "alphatriangle.lint.v1"`
and carries `baseline_path`. Exit 0 clean, 1 findings or a stale
baseline entry, 2 a parse error or an unknown rule.

Every command but `serve`, `train`, `eval`, `league`, `warm`, `fit`, `tune`, `play` and
`devices` imports neither torch nor numpy: they read files, and the
supervisor's and the fleet's parents outlive a wedged card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

# The port's graftlint baseline, inside the linted tree.
LINT_BASELINE = "lint_baseline.json"


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
    from .serving import PolicyService, build_serve_telemetry, run_simulated_load
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
    # The step served: a checkpoint committed after the restore (during the
    # warm start or the pre-flight) is the first hot reload's.
    served_step = {"step": None, "reloaded": []}
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
            served_step["step"] = loaded.global_step
    if args.gumbel:
        mcts = GumbelMCTS(env, extractor, net.model, mcts_cfg, net.support, exploit=True)
    else:
        mcts = BatchedMCTS(env, extractor, net.model, mcts_cfg, net.support)
    # The service's own run directory: its heartbeat, ledger, flight ring
    # and trace, under the served run's root (a step directory's own, for
    # --checkpoint without --root-dir).
    serve_run = args.serve_run_name or (f"serve_{args.run_name}" if args.run_name else "serve")
    root = args.root_dir
    if root is None and args.checkpoint:
        root = str(Path(args.checkpoint).resolve().parents[4])
    run_dir = PersistenceConfig(
        RUN_NAME=serve_run, **({"ROOT_DATA_DIR": root} if root else {})
    ).get_run_base_dir()
    telemetry = build_serve_telemetry(run_dir, serve_run, env_cfg, model_cfg, device=device)
    from .compile_cache import get_build_cache

    get_build_cache().set_tracer(telemetry.tracer)
    service = PolicyService(
        env, extractor, net, mcts, slots=args.slots, rng_seed=args.seed, ladder=args.buckets,
        telemetry=telemetry,
    )
    ladder_note = f", ladder {','.join(map(str, service.ladder.rungs))}" if args.buckets else ""
    say(
        f"serve: {source} net, board {env_cfg.ROWS}x{env_cfg.COLS}, {args.slots} slots"
        f"{ladder_note}, {args.sims} sims/move{', gumbel' if args.gumbel else ''}, "
        f"{model_cfg.INFERENCE_PRECISION} weights, device {device}, run dir {run_dir}"
    )
    if not args.no_warm:
        # Every rung, before the load: a switch mid-stream then costs the
        # migration, not a cold width (the kernels build here on a card).
        t_warm = time.perf_counter()
        service.warm()
        say(f"serve: warmed rungs {list(service.ladder.rungs)} ({time.perf_counter() - t_warm:.1f}s)")
    preflight = None
    if not args.no_preflight:
        preflight = _serve_preflight(service, device, args.limit_gb, say)
        if preflight["exit"] == 1:
            say("serve: refusing to serve an over-budget config")
            telemetry.close(step=0)
            return 1
    # The report's launches are the served dispatches' (not the warm-up's
    # or the pre-flight's).
    launches_before = _kernel_launches()

    # Hot reload: every --reload-every dispatches, poll the run's newest
    # committed checkpoint; a new step is restored and swapped in
    # between dispatches.

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
    telemetry.start()
    try:
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
                tick_every=args.tick_every,
            ))
            if args.smoke or deadline is None or time.monotonic() >= deadline:
                break
    except KeyboardInterrupt:
        say("serve: interrupted; draining")
    finally:
        # The window since the last tick, then the last tick and close.
        window = service.serve_stats(drain=False)
        service.tick()
        telemetry.close(step=service.dispatch_count)
    if not waves:
        return 1
    stats = waves[-1]
    launches = {k: v - launches_before[k] for k, v in _kernel_launches().items()}
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
        **window,
        "run": serve_run,
        "ledger": str(run_dir / "metrics.jsonl"),
        "preflight": preflight,
        "kernel_launches": launches,
    }
    print(json.dumps(report))
    ok = report["sessions_served"] >= args.sessions * len(waves)
    if args.smoke:
        # The smoke's gate: every session served and the ledger landed.
        ok = ok and (run_dir / "metrics.jsonl").exists()
    return 0 if ok else 1


def _serve_preflight(service, device, limit_gb, say) -> dict:
    """The serve pre-flight (JAX `cmd_serve`'s): each rung's dispatch run
    once with its allocator peak measured (`telemetry/memory.py`
    `measure_program`), the worst rung's resident weights and slot
    states plus its peak against the card's limit. Returns {budget,
    limit, source, exit, reason}; exit 1 over budget or out of memory,
    None when the device keeps no allocator statistics (the CPU)."""
    import torch

    from .telemetry.memory import (
        fit_verdict,
        fmt_bytes,
        measure_program,
        resolve_bytes_limit,
        serve_budget_bytes,
        tree_bytes,
    )

    weights = tree_bytes(list(service.net.model.parameters()))
    record, budget = None, 0
    try:
        for rung in service.ladder.rungs:
            slots = tree_bytes(service.sessions.states) * rung // max(1, service.sessions.slots)
            rec = measure_program(f"serve/b{rung}", lambda r=rung: service.warm_rung(r), device,
                                  argument_bytes=weights + slots)
            if rec is not None and serve_budget_bytes(rec) >= budget:
                record, budget = rec, serve_budget_bytes(rec)
    except torch.cuda.OutOfMemoryError as exc:
        say(f"serve: pre-flight ran out of memory ({type(exc).__name__})")
        return {"budget": None, "limit": None, "source": None, "exit": 1, "reason": "out of memory"}
    limit, source = resolve_bytes_limit(limit_gb, device=device)
    if record is None:
        say("serve: pre-flight skipped (no allocator statistics on this device)")
        return {"budget": None, "limit": limit, "source": source, "exit": None, "reason": "skipped"}
    code, reason = fit_verdict(budget, limit)
    say(f"serve: pre-flight {fmt_bytes(budget)} — {reason}")
    service.telemetry.record_memory(record)
    return {"budget": budget, "limit": limit, "source": source, "exit": code, "reason": reason}


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
    distributed_config = None
    if args.distributed or args.coordinator is not None:
        from .parallel import DistributedConfig

        distributed_config = DistributedConfig(
            ENABLED=True, COORDINATOR_ADDRESS=args.coordinator, NUM_PROCESSES=args.num_processes,
            PROCESS_ID=args.process_id, BACKEND=args.dist_backend,
        )
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
        log_level=args.log_level, distributed_config=distributed_config, **configs,
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
    from .telemetry.perf import fold_league_and_fleet, fold_memory_budget, summarize_utilization

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
    # The static memory budget of the run's kind:"memory" records
    # (`cli compare` gates it as memory_budget_bytes).
    mem_budget = fold_memory_budget(summary, records)
    flight = read_flight(ledger.parent / FLIGHT_FILENAME)
    programs = summarize_flight(flight)
    if programs:
        summary["programs"] = programs
    league, fleet = fold_league_and_fleet(summary, records, ledger)
    # The device stat-packs' kind:"device_stats" records: the ds_* fields
    # and the lines below (none without records).
    devstats = summarize_device_stats([r for r in records if r.get("kind") == "device_stats"])
    if devstats is not None:
        summary.update(devstats)
    # The roofline fold (telemetry/roofline.py), when the run has cost
    # records: the roofline_* fields, the programs' intensity, bound and
    # roofline fraction, and the gaps line.
    roof = _fold_roofline(summary, records, flight, ledger, programs)
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
    if summary.get("mem_peak_bytes_in_use") is not None or mem_budget is not None:
        print(
            f"  memory       peak {_fmt_cell(summary.get('mem_peak_bytes_in_use'), ',.2f', 2**-30, ' GiB')}"
            f"   in use {_fmt_cell(summary.get('mem_bytes_in_use_last'), ',.2f', 2**-30, ' GiB')}"
            f"   limit {_fmt_cell(summary.get('mem_bytes_limit'), ',.2f', 2**-30, ' GiB')}"
            f"   est budget {_fmt_cell(mem_budget, ',.2f', 2**-30, ' GiB')} (cli mem)"
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
    if roof is not None and roof.get("attribution"):
        attrib = roof["attribution"]
        gap_text = "  ".join(
            f"{cat} {_fmt_cell(sec, ',.1f', 1, 's')}"
            for cat, sec in (attrib.get("gaps") or {}).items()
            if isinstance(sec, (int, float)) and sec > 0
        )
        print(
            f"  roofline     idle {_fmt_cell(attrib.get('chip_idle_fraction'), ',.1f', 100.0, '%')}"
            f"   dispatch {_fmt_cell(attrib.get('dispatch_s'), ',.1f', 1, 's')}"
            f"   attributed {_fmt_cell(attrib.get('attributed_fraction'), ',.1f', 100.0, '%')}"
            + (f"   gaps: {gap_text}" if gap_text else "")
        )
    if programs:
        # Roofline columns only when the run has cost records.
        width = max(max(len(p["program"]) for p in programs), 7)
        head = f"  {'program':<{width}}  {'count':>6}  {'p50':>9}  {'p95':>9}  {'total':>9}  err"
        if roof is not None:
            head += f"  {'intensity':>10}  {'bound':>7}  {'roofline':>8}"
        print(head)
        for p in programs:
            line = (
                f"  {p['program']:<{width}}  {p['count']:>6}"
                f"  {_fmt_cell(p['wall_s_p50'], ',.1f', 1e3, 'ms'):>9}"
                f"  {_fmt_cell(p['wall_s_p95'], ',.1f', 1e3, 'ms'):>9}"
                f"  {_fmt_cell(p['wall_s_total'], ',.1f', 1, 's'):>9}  {p['errors']}"
            )
            if roof is not None:
                line += (
                    f"  {_fmt_cell(p.get('intensity'), ',.1f'):>10}"
                    f"  {p.get('bound') or '—':>7}"
                    f"  {_fmt_cell(p.get('roofline_fraction'), ',.2f', 100.0, '%'):>8}"
                )
            print(line)
    print(
        f"  trend        {_fmt_cell(summary.get('throughput_trend'), '+,.1f', 100.0, '%')} "
        "(2nd-half vs 1st-half throughput)"
    )
    return 0


def _fold_roofline(summary: dict, records: list, flight: list, ledger: Path, programs) -> "dict | None":
    """`cli perf`'s roofline fold, as the JAX command folds it: with cost
    records, the roofline summary's machine balance and gap attribution
    as roofline_* fields and each program's intensity, bound and roofline
    fraction (in place). None without cost records."""
    from .telemetry.roofline import summarize_roofline

    cost_records = [r for r in records if r.get("kind") == "cost"]
    if not cost_records:
        return None
    roof = summarize_roofline(
        cost_records, flight, device_kind=summary.get("device_kind") or "",
        peak_tflops=summary.get("peak_bf16_tflops"),
        trace_path=[ledger.parent / "trace.json", ledger.parent / "profile_data"],
    )
    if roof is None:
        return None
    if roof.get("machine_balance_flops_per_byte") is not None:
        summary["roofline_machine_balance_flops_per_byte"] = roof["machine_balance_flops_per_byte"]
        summary["roofline_peak_hbm_gbps"] = roof.get("peak_hbm_gbps")
    attrib = roof.get("attribution")
    if attrib:
        summary["roofline_chip_idle_fraction"] = attrib.get("chip_idle_fraction")
        summary["roofline_attributed_fraction"] = attrib.get("attributed_fraction")
        summary["roofline_dispatch_s"] = attrib.get("dispatch_s")
        summary["roofline_gap_s"] = attrib.get("gap_s")
        for cat, sec in (attrib.get("gaps") or {}).items():
            summary[f"roofline_gap_{cat}_s"] = sec
    rows = {r["program"]: r for r in roof.get("programs") or []}
    for p in programs or []:
        r = rows.get(p.get("program"))
        if r is not None:
            p["intensity"] = r.get("intensity")
            p["bound"] = r.get("bound")
            p["roofline_fraction"] = r.get("roofline_fraction")
    return roof


_BENCH_TARGETS = ("auto", "smoke", "cpu", "1", "2", "3", "4", "5")


def _apply_bench_target(target: "str | None", environ: dict) -> None:
    """Map a warm / fit target onto the plan's environment knobs, as the
    JAX command does: digits 1..5 select a BASELINE preset (BENCH_CONFIG),
    a path a `tuned_preset.json` (BENCH_TUNED_PRESET); auto / smoke / cpu
    leave those two knobs, where the environment sets them, in charge."""
    if not target or target in ("auto", "smoke", "cpu"):
        return
    if target.isdigit():
        environ["BENCH_CONFIG"] = target
        return
    if Path(target).is_file():
        environ["BENCH_TUNED_PRESET"] = target
        return
    raise SystemExit(
        f"Unknown target {target!r}: expected one of {'|'.join(_BENCH_TARGETS)} or a "
        "tuned_preset.json path."
    )


def _bench_plan(args: argparse.Namespace):
    """(device, plan) of a warm / fit target: `--device`, else the CPU for
    the `cpu` target, else CUDA; the plan at that device's scale."""
    import os

    from .bench_config import resolve_bench_plan
    from .device import resolve_device

    device = resolve_device(args.device or ("cpu" if args.target == "cpu" else None))
    environ = dict(os.environ)
    smoke = args.target == "smoke" or environ.get("BENCH_SMOKE") == "1"
    _apply_bench_target(args.target, environ)
    return device, resolve_bench_plan(smoke, device.type, environ=environ)


def cmd_warm(args: argparse.Namespace) -> int:
    """Build every kernel and run each hot program of a plan once at its
    shapes (`warm.py`), so the next process on the card starts from the
    build cache and warm libraries. Prints one JSON report (a row a
    program: status and seconds; the build cache's hits and misses).
    Exit 0 when every program ran, 1 otherwise."""
    from .warm import warm_bench_programs

    device, plan = _bench_plan(args)
    programs = set(args.programs.split(",")) if args.programs else None
    report = warm_bench_programs(
        plan, device, programs=programs, progress=lambda msg: print(msg, file=sys.stderr, flush=True),
        jobs=args.jobs,
    )
    print(json.dumps(report))
    rows = report["programs"]
    ok = all(r["status"] in ("ran", "skipped-cpu") for r in rows)
    return 0 if ok and any(r["status"] == "ran" for r in rows[1:]) else 1


def cmd_fit(args: argparse.Namespace) -> int:
    """Memory pre-flight of a plan: the learner state, the replay ring and
    each hot program run once at the plan's shapes with the caching
    allocator's peak measured (`telemetry/memory.py` `estimate_fit`;
    eager PyTorch has no ahead-of-time memory analysis), composed into
    the per-device budget and held against the card's memory. Exit 0
    fits, 1 over budget (or out of memory in a measured run), 2 no limit
    known (the CPU without --limit-gb or ALPHATRIANGLE_DEVICE_BYTES_LIMIT)."""
    import os

    from .telemetry.memory import FIT_OVER, estimate_fit, fit_verdict, fmt_bytes, resolve_bytes_limit

    device, plan = _bench_plan(args)
    print(
        f"fit: device={device} scale={plan.scale} batch={plan.sp_batch} chunk={plan.chunk} "
        f"lbatch={plan.lbatch} device_replay={plan.device_replay}",
        file=sys.stderr, flush=True,
    )
    programs = set(args.programs.split(",")) if args.programs else None
    report = estimate_fit(
        plan, device, serve=args.serve, programs=programs,
        progress=lambda msg: print(msg, file=sys.stderr, flush=True),
    )
    budget = report["budget"]
    limit, source = resolve_bytes_limit(args.limit_gb, dict(os.environ), device=device)
    if report["oom"] is not None:
        code, reason = FIT_OVER, f"OVER BUDGET: a measured run ran out of memory ({report['oom']})"
    else:
        code, reason = fit_verdict(budget["total_bytes"], limit)
    if args.json:
        print(json.dumps({
            "schema": "alphatriangle.fit.v1", "scale": plan.scale, "backend": device.type,
            "budget": budget, "bytes_limit": limit, "limit_source": source, "exit": code,
            "reason": reason, "records": report["records"],
        }))
        return code
    print(f"fit {plan.scale} on {device}")
    for label, key in (
        ("train state", "train_state_bytes"),
        ("replay ring (device)", "replay_ring_bytes"),
        ("rollout residency", "rollout_resident_bytes"),
        ("program transient", "program_transient_bytes"),
    ):
        print(f"  {label:<22} {fmt_bytes(budget[key]):>12}")
    print(f"  {'TOTAL (per device)':<22} {fmt_bytes(budget['total_bytes']):>12}")
    print(f"  limit                  {fmt_bytes(limit):>12}" + (f"  [{source}]" if limit is not None else ""))
    print(reason)
    return code


def _tune_axes(scale: str, plan, smoke: bool, device_count: int) -> tuple:
    """Default (batches, capacities, chunks, fused_ks, dps) of a scale, as
    the JAX command brackets the plan: each axis reaches above the plan's
    value; smoke keeps the lattice to two candidates."""
    b0, cap0, t0, k0 = plan.sp_batch, plan.train.BUFFER_CAPACITY, plan.chunk, plan.fused_k
    if smoke:
        batches, capacities, chunks, fused_ks = [max(4, b0 // 2), b0], [cap0], [t0], [k0]
    elif scale == "cpu":
        batches, capacities, chunks, fused_ks = [b0 // 2, b0, b0 * 2], [cap0, cap0 * 2], [t0, t0 * 2], [k0]
    else:
        batches = [b0 // 2, b0, b0 * 2, b0 * 4]
        capacities = [cap0, cap0 * 5, cap0 * 10]
        chunks = [t0, t0 * 2]
        fused_ks = [k0, k0 * 2]
    dps = [1]
    if device_count > 1 and not smoke:
        dps.append(device_count)
    return batches, capacities, chunks, fused_ks, dps


def cmd_tune(args: argparse.Namespace) -> int:
    """The measured-fit autotuner (`autotune/`): the feasible candidate of
    highest predicted games/h around a plan, written as a
    `tuned_preset.json`. Exit 0 a winner, 1 (FIT_OVER) none fits, 2
    (FIT_UNKNOWN) no byte limit known."""
    import os

    import torch

    from .autotune import (
        SearchSpace,
        build_tuned_preset,
        calibration_from_targets,
        default_artifact_path,
        run_search,
        write_tuned_preset,
    )
    from .autotune import search as search_mod
    from .autotune.search import candidate_mcts, materialize_candidate
    from .bench_config import resolve_bench_plan
    from .device import resolve_device
    from .telemetry.memory import FIT_OVER, FIT_UNKNOWN, fmt_bytes, resolve_bytes_limit
    from .utils.flops import peak_bf16_tflops_info

    wanted = args.device or ("cpu" if args.target == "cpu" else "cuda")
    device = resolve_device("cuda" if wanted == "auto" else wanted)
    backend = device.type
    environ = dict(os.environ)
    smoke = args.target == "smoke" or args.smoke or environ.get("BENCH_SMOKE") == "1"
    _apply_bench_target(args.target, environ)
    plan = resolve_bench_plan(smoke, backend, environ=environ)

    limit, limit_source = resolve_bytes_limit(args.limit_gb, environ, device=device)
    if limit is None:
        print(
            "tune: no per-device byte limit known; pass --limit-gb or set "
            "ALPHATRIANGLE_DEVICE_BYTES_LIMIT (a search without a memory budget has no "
            "feasibility oracle).",
            file=sys.stderr,
        )
        return FIT_UNKNOWN

    device_kind = torch.cuda.get_device_name(device) if backend == "cuda" else "cpu"
    peak, peak_source = peak_bf16_tflops_info(device_kind)
    device_count = torch.cuda.device_count() if backend == "cuda" else 1

    # The loop being tuned: the megastep where the plan keeps its ring on
    # the device (the card), else the synchronous loop.
    mode = args.mode
    if mode == "auto":
        mode = "megastep" if plan.device_replay else "sync"

    batches, capacities, chunks, fused_ks, dps = _tune_axes(plan.scale, plan, smoke, device_count)
    if args.batches:
        batches = [int(v) for v in args.batches.split(",")]
    if args.capacities:
        capacities = [int(v) for v in args.capacities.split(",")]
    if args.chunks:
        chunks = [int(v) for v in args.chunks.split(",")]
    if args.fused_k:
        fused_ks = [int(v) for v in args.fused_k.split(",")]
    if args.dp:
        dps = [int(v) for v in args.dp.split(",")]
    kernel_backends = args.kernel_backends.split(",") if args.kernel_backends else ["xla"]
    space = SearchSpace(
        geometries=args.geometries.split(",") if args.geometries else ["plan"],
        batches=batches,
        capacities=capacities,
        chunks=chunks,
        fused_ks=fused_ks,
        dps=dps,
        backup_updates=kernel_backends,
        per_samples=kernel_backends,
        precisions=args.precisions.split(",") if args.precisions else ["float32"],
        serve_bucket_ladders=(
            ["" if v.strip() in ("off", "") else v.strip() for v in args.serve_buckets]
            if args.serve_buckets else [""]
        ),
        tree_reuses=(
            [v.strip() == "on" for v in args.tree_reuse.split(",")] if args.tree_reuse else [False]
        ),
    )
    calibration = calibration_from_targets(args.calibrate or [], root_dir=args.root_dir)

    def say(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    say(
        f"tune: backend={backend} device={device} scale={plan.scale} mode={mode} "
        f"space={space.size()} candidates limit={fmt_bytes(limit)} [{limit_source}] "
        f"peak={peak or 'unknown'} TFLOP/s [{peak_source}] "
        f"calibration={','.join(calibration.sources)}"
    )
    oracle = search_mod.default_oracle(
        plan.mcts, mode, device_replay=plan.device_replay or mode == "megastep", progress=say,
        device=device,
    )
    result = run_search(
        space, plan.env, plan.model, plan.mcts, plan.train, limit, calibration=calibration,
        peak_tflops=peak, mode=mode, oracle=oracle, progress=say,
    )

    run_name = args.run_name or f"tune_{plan.scale}"
    payload = None
    out_path = None
    if result.best is not None:
        env_cfg, model_cfg, train_cfg = materialize_candidate(
            result.best, plan.env, plan.model, plan.train, mode
        )
        train_cfg = train_cfg.model_copy(update={"RUN_NAME": run_name})
        payload = build_tuned_preset(
            result, env_cfg, model_cfg, candidate_mcts(plan.mcts, result.best), train_cfg,
            scale=plan.scale, mode=mode, backend=backend, device_kind=device_kind,
            limit_bytes=limit, limit_source=limit_source, calibration=calibration,
            run_name=run_name,
        )
        out_path = Path(args.out or default_artifact_path(run_name, root_dir=args.root_dir))
        write_tuned_preset(payload, out_path)

    if args.json:
        print(json.dumps({
            "schema": "alphatriangle.tune_report.v1",
            "scale": plan.scale,
            "backend": backend,
            "mode": mode,
            "bytes_limit": limit,
            "limit_source": limit_source,
            "rows": result.rows,
            "oracle_calls": result.oracle_calls,
            "best": payload,
            "artifact": str(out_path) if out_path else None,
            "exit": 0 if result.best is not None else FIT_OVER,
            # The port's own: each oracle call's seconds and allocated bytes
            # around it, and the kernels the oracle's programs launched.
            "device": str(device),
            "device_kind": device_kind,
            "oracle": list(getattr(oracle, "calls", [])),
            "kernel_launches": _kernel_launches(),
        }, default=str))
    else:
        print(f"tune {plan.scale} on {backend} (mode {mode})")
        print(
            f"{'geometry':<9} {'B':>6} {'cap':>8} {'T':>4} {'K':>4} "
            f"{'dp':>3} {'pred games/h':>13} {'budget':>10}  status"
        )
        for row in result.rows:
            gph = (row["predicted"] or {}).get("games_per_hour")
            gph_s = f"{gph:.1f}" if isinstance(gph, (int, float)) else "n/a"
            budget = row["budget_total_bytes"]
            budget_s = fmt_bytes(budget) if budget else "n/a"
            detail = f" ({row['detail']})" if row["detail"] else ""
            print(
                f"{row['geometry']:<9} {row['sp_batch']:>6} {row['capacity']:>8} {row['chunk']:>4} "
                f"{row['fused_k']:>4} {row['dp']:>3} {gph_s:>13} {budget_s:>10}  "
                f"{row['status']}{detail}"
            )
        if result.best is not None:
            pred = result.best_prediction or {}
            print(
                f"tune: best {result.best.label()} — predicted "
                f"{pred.get('games_per_hour', 0.0):.1f} games/h, "
                f"budget {fmt_bytes(result.best_budget['total_bytes'])} of {fmt_bytes(limit)} "
                f"({result.oracle_calls} oracle call(s))"
            )
            print(f"tune: wrote {out_path}")
            print(f"tune: consume with `cli train --preset {out_path}`, `cli warm {out_path}` or "
                  f"`cli fit {out_path}`")
        else:
            print(
                f"tune: no feasible candidate under {fmt_bytes(limit)} "
                f"({result.oracle_calls} oracle call(s), {len(result.rows)} candidates examined)"
            )
    return 0 if result.best is not None else FIT_OVER


def cmd_play(args: argparse.Namespace) -> int:
    """Interactive text play (the reference's `trianglengin play`): the
    native host engine, or with `--engine jax` the port's `GameState`
    engine on `--device` (default the card). `auto` takes the native
    engine where it builds. The transcript is the JAX command's, but for
    the engine's name ("torch" for the GameState engine)."""
    import numpy as np

    from .config import EnvConfig
    from .env.native import native_available, native_build_error
    from .env.render import render_grid, render_shape
    from .env.shapes import bank_shape_triangles

    env_cfg = EnvConfig()
    use_native = args.engine == "native" or (args.engine == "auto" and native_available())
    if args.engine == "native" and not native_available():
        print(f"native engine unavailable: {native_build_error()}")
        return 1

    if use_native:
        from .env import TriangleEnv
        from .env.native import NativeTriangleEnv

        # The host engine reads the tables; nothing of it runs on a device.
        env = TriangleEnv(env_cfg, device="cpu")
        native = NativeTriangleEnv(env)
        batch = native.new_batch(1, seed=args.seed)

        def state_view():
            return (env.unpack_grid_np(batch.occupied[0]), batch.shape_idx[0],
                    float(batch.score[0]), bool(batch.done[0]))

        def do_step(action):
            rewards, _ = native.step(batch, np.asarray([action], np.int32))
            return float(rewards[0])

        def valid_mask():
            return native.valid_mask(batch)[0]

    else:
        from .env.game_state import GameState

        game = GameState(env_cfg, initial_seed=args.seed, device=args.device)
        env = game._env

        def state_view():
            return (
                game.get_grid_data_np()["occupied"],
                np.asarray([-1 if s is None else i for i, s in enumerate(game.get_shapes())]),
                game.game_score(),
                game.is_over(),
            )

        def do_step(action):
            reward, _ = game.step(action)
            return reward

        def valid_mask():
            return game.valid_action_mask()

    death = env.geometry.death
    cells = env_cfg.ROWS * env_cfg.COLS
    moves = 0
    script = list(args.script.split(";")) if args.script else None
    print(
        f"Board {env_cfg.ROWS}x{env_cfg.COLS}, {env_cfg.NUM_SHAPE_SLOTS} shape slots, engine="
        f"{'native' if use_native else 'torch'}."
    )
    print("Moves: 'SLOT ROW COL' | 'v' valid count | 'q' quit.")
    while True:
        occ, hand, score, done = state_view()
        print()
        print(render_grid(occ, death))
        print(f"score={score:.1f}  moves={moves}")
        shapes = None if use_native else game.get_shapes()
        for slot in range(env_cfg.NUM_SHAPE_SLOTS):
            if use_native:
                sidx = int(hand[slot])
                tris = None if sidx < 0 else bank_shape_triangles(env.bank, sidx)
            else:
                tris = None if shapes[slot] is None else shapes[slot].triangles
            label = (
                "(consumed)"
                if tris is None
                else "\n".join("    " + line for line in render_shape(tris).splitlines())
            )
            print(f"  slot {slot}:")
            print(label)
        if done:
            print("GAME OVER.")
            return 0
        if script is not None:
            if not script:
                return 0
            line = script.pop(0).strip()
            print(f"> {line}")
        else:
            try:
                line = input("> ").strip()
            except EOFError:
                return 0
        if line in ("q", "quit", "exit"):
            return 0
        if line == "v":
            print(f"valid placements: {int(valid_mask().sum())}")
            continue
        try:
            slot, r, c = (int(x) for x in line.split())
            action = slot * cells + r * env_cfg.COLS + c
        except ValueError:
            print("Expected: SLOT ROW COL")
            continue
        if not 0 <= action < env_cfg.action_dim:
            print("Out of range.")
            continue
        if not valid_mask()[action]:
            print("Invalid placement (would forfeit); pick another.")
            continue
        reward = do_step(action)
        moves += 1
        print(f"reward {reward:+.1f}")


def _run_ledger(args: argparse.Namespace):
    """The metrics ledger a reader command names (a run name, a run
    directory or a metrics.jsonl path; the newest run by default), or
    None, said on stderr."""
    from .telemetry.ledger import resolve_ledger_path

    target = Path(args.run) if args.run else None
    if target is not None and target.exists():
        ledger = resolve_ledger_path(target)
    else:
        run_dir = _resolve_run_dir(args.run, args.root_dir)
        if run_dir is None:
            return None
        ledger = resolve_ledger_path(run_dir)
    if ledger is None:
        print(f"no metrics ledger for {args.run}", file=sys.stderr)
    return ledger


def cmd_mem(args: argparse.Namespace) -> int:
    """A run's memory-attribution table from its `metrics.jsonl` alone
    (`kind:"memory"` and `"util"` records); imports no torch. Exit 0, or
    2 when the run has no memory records (telemetry off, or an older run)."""
    from .telemetry.ledger import read_ledger
    from .telemetry.memory import attribution_rows, compose_budget, fmt_bytes

    ledger = _run_ledger(args)
    if ledger is None:
        return 2
    records = read_ledger(ledger, kinds={"memory"})
    utils = read_ledger(ledger, kinds={"util"})
    observed = next(
        (u for u in reversed(utils) if isinstance(u.get("mem_bytes_in_use"), (int, float))), None
    )
    if not records and observed is None:
        print(
            f"{ledger}: no memory records (the run predates the memory ledger, or telemetry was "
            "disabled)",
            file=sys.stderr,
        )
        return 2
    budget = compose_budget(records)
    if args.json:
        print(json.dumps({"source": str(ledger), "records": records, "budget": budget,
                          "observed": observed}))
        return 0
    print(f"mem {ledger}")
    rows = attribution_rows(records)
    if rows:
        width = max(max(len(r[0]) for r in rows), 9)
        print(f"  {'component':<{width}}  {'bytes':>12}  detail")
        for component, total, detail in rows:
            print(f"  {component:<{width}}  {fmt_bytes(total):>12}  {detail}")
        print(
            f"  static budget (per device): {fmt_bytes(budget['total_bytes'])} = "
            f"state {fmt_bytes(budget['train_state_bytes'])}"
            f" + ring {fmt_bytes(budget['replay_ring_bytes'])}"
            f" + rollout {fmt_bytes(budget['rollout_resident_bytes'])}"
            f" + transient {fmt_bytes(budget['program_transient_bytes'])}"
        )
    if observed is not None:
        limit = observed.get("mem_bytes_limit")
        util = observed.get("mem_utilization")
        print(
            f"  observed: {fmt_bytes(observed.get('mem_bytes_in_use'))} in use, "
            f"peak {fmt_bytes(observed.get('mem_peak_bytes_in_use'))}"
            + (
                f", limit {fmt_bytes(limit)}"
                + (f" ({util:.1%} used)" if isinstance(util, (int, float)) else "")
                if limit else ""
            )
            + f" (step {observed.get('step')})"
        )
    return 0


def cmd_roofline(args: argparse.Namespace) -> int:
    """A run's roofline report from its files alone (`metrics.jsonl`'s
    `kind:"cost"` and util records, `flight.jsonl`, `trace.json` and a
    `--profile` run's `profile_data/` traces): each
    program's analytic arithmetic intensity against the card's machine
    balance, its bound and achieved share of the roofline at its
    measured p50 wall, and the gaps between dispatches by host category;
    imports no torch. Exit 0, or 2 with neither cost records nor a
    flight timeline."""
    from .telemetry.flight import FLIGHT_FILENAME, read_flight
    from .telemetry.ledger import read_ledger
    from .telemetry.perf import summarize_utilization
    from .telemetry.roofline import summarize_roofline

    ledger = _run_ledger(args)
    if ledger is None:
        return 2
    run_dir = ledger.parent
    records = read_ledger(ledger)
    util = summarize_utilization(records) or {}
    summary = summarize_roofline(
        [r for r in records if r.get("kind") == "cost"],
        read_flight(run_dir / FLIGHT_FILENAME),
        device_kind=util.get("device_kind") or "",
        peak_tflops=util.get("peak_bf16_tflops"),
        trace_path=[run_dir / "trace.json", run_dir / "profile_data"],
    )
    if summary is None:
        print(
            f"{run_dir}: no cost records or flight timeline (the run predates the roofline "
            "plane, or telemetry was disabled)",
            file=sys.stderr,
        )
        return 2
    if args.json:
        summary["source"] = str(ledger)
        print(json.dumps(summary))
        return 0
    peak = summary.get("peak_bf16_tflops")
    hbm = summary.get("peak_hbm_gbps")
    hbm_source = summary.get("peak_hbm_source")
    balance = summary.get("machine_balance_flops_per_byte")
    print(f"roofline {run_dir}")
    print(
        f"  device       {summary.get('device_kind') or '?'}"
        f"   peak bf16 {_fmt_cell(peak, ',.0f', 1, ' TFLOP/s') if peak else 'unknown'}"
        f"   memory {_fmt_cell(hbm, ',.0f', 1, ' GB/s') if hbm else 'unknown'}"
        + (f" [{hbm_source}]" if hbm_source not in (None, "unknown") else "")
        + (f"   balance {_fmt_cell(balance, ',.0f', 1, ' FLOP/B')}" if balance is not None else "")
    )
    attrib = summary.get("attribution")
    if attrib:
        print(
            f"  attribution  wall {_fmt_cell(attrib.get('wall_s'), ',.1f', 1, 's')}"
            f"   dispatch {_fmt_cell(attrib.get('dispatch_s'), ',.1f', 1, 's')}"
            f"   idle {_fmt_cell(attrib.get('chip_idle_fraction'), ',.1f', 100.0, '%')}"
            f"   attributed {_fmt_cell(attrib.get('attributed_fraction'), ',.1f', 100.0, '%')}"
            f"   dispatches {_fmt_cell(attrib.get('dispatches'), ',.0f')}"
        )
        gap_text = "   ".join(
            f"{cat} {_fmt_cell(sec, ',.2f', 1, 's')}"
            for cat, sec in (attrib.get("gaps") or {}).items() if isinstance(sec, (int, float))
        )
        if gap_text:
            print(f"  gaps         {gap_text}")
    else:
        print("  attribution  — (no flight timeline)")
    programs = summary.get("programs") or []
    if programs:
        width = max(max(len(p["program"]) for p in programs), 7)
        print(
            f"  {'program':<{width}}  {'count':>6}  {'p50':>9}  {'total':>9}"
            f"  {'gflops':>9}  {'intensity':>10}  {'bound':>7}  {'roofline':>8}"
        )
        for p in programs:
            print(
                f"  {p['program']:<{width}}"
                f"  {_fmt_cell(p.get('count'), ',.0f'):>6}"
                f"  {_fmt_cell(p.get('wall_s_p50'), ',.1f', 1e3, 'ms'):>9}"
                f"  {_fmt_cell(p.get('wall_s_total'), ',.1f', 1, 's'):>9}"
                f"  {_fmt_cell(p.get('flops'), ',.2f', 1e-9):>9}"
                f"  {_fmt_cell(p.get('intensity'), ',.1f'):>10}"
                f"  {p.get('bound') or '—':>7}"
                f"  {_fmt_cell(p.get('roofline_fraction'), ',.2f', 100.0, '%'):>8}"
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


def cmd_lint(args: argparse.Namespace) -> int:
    """graftlint for the port (`analysis/`): the JAX package's seven rules,
    each restated for eager PyTorch, over the port's package or `path`.
    Imports neither torch nor JAX. The default baseline is the port's own
    `lint_baseline.json` inside the linted tree (never the repository
    root's, which holds the JAX package's keys).

    Exit 0 clean / 1 findings or stale baseline entries / 2 parse
    error (or unknown --rule)."""
    from .analysis import run_lint, write_baseline

    root = Path(args.path) if args.path else Path(__file__).resolve().parent
    if not root.exists():
        print(f"lint root {root} does not exist", file=sys.stderr)
        return 2
    if args.baseline is not None:
        baseline = Path(args.baseline)
    else:
        candidate = root / LINT_BASELINE
        baseline = candidate if candidate.exists() else None
    try:
        report = run_lint(root, rule_names=args.rule or None, baseline_path=baseline)
    except ValueError as e:  # unknown rule / corrupt baseline
        print(f"lint: {e}", file=sys.stderr)
        return 2
    if args.write_baseline:
        target = baseline or root / LINT_BASELINE
        write_baseline(target, report.findings)
        n = len(report.findings)
        print(f"baseline written: {target} ({n} entr{'y' if n == 1 else 'ies'})")
        return 0
    if args.json:
        payload = report.as_dict()
        payload["baseline_path"] = str(baseline) if baseline else None
        print(json.dumps(payload))
    else:
        print(report.render())
    return report.exit_code


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
    serve.add_argument("--device", default=None,
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
    serve.add_argument("--serve-run-name", default=None,
                       help="Run directory of the service's own telemetry (default: "
                       "serve_<run-name>, or 'serve').")
    serve.add_argument("--smoke", action="store_true",
                       help="Bounded mode: one wave of --sessions sessions, exit 1 unless every "
                       "session was served and the ledger landed.")
    serve.add_argument("--tick-every", type=int, default=8, metavar="DISPATCHES",
                       help="Ledger and heartbeat tick cadence in dispatches (default 8).")
    serve.add_argument("--limit-gb", type=float, default=None, metavar="GIB",
                       help="Pre-flight device byte limit (also: ALPHATRIANGLE_DEVICE_BYTES_LIMIT); "
                       "default: the card's memory.")
    serve.add_argument("--no-warm", action="store_true",
                       help="Skip the warm start (a search at every rung before the load).")
    serve.add_argument("--no-preflight", action="store_true",
                       help="Skip the memory pre-flight (every rung's dispatch measured against "
                       "the limit; exit 1 over it).")
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
                       "trace of iterations 1-2 (a megastep run's megasteps 1-2) into "
                       "runs/<run>/profile_data/.")
    train.add_argument("--log-level", default="INFO", choices=["DEBUG", "INFO", "WARNING", "ERROR"])
    train.add_argument("--distributed", action="store_true",
                       help="Data-parallel training, one rank per device, on torch.distributed: "
                       "torchrun's environment, or --coordinator/--num-processes/--process-id.")
    train.add_argument("--coordinator", default=None, metavar="HOST:PORT|file://PATH",
                       help="Rendezvous store of the process group (rank 0 serves HOST:PORT).")
    train.add_argument("--num-processes", type=int, default=None, help="World size.")
    train.add_argument("--process-id", type=int, default=None, help="This process's rank.")
    train.add_argument("--dist-backend", default="auto", choices=["auto", "nccl", "gloo"],
                       help="auto: NCCL on CUDA, gloo on the CPU; ranks sharing one card need gloo.")
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

    warm = sub.add_parser(
        "warm",
        help="Build every kernel and run each hot program of a plan once at its shapes "
        "(exit 0 when every program ran).",
    )
    warm.add_argument("target", nargs="?", default="auto",
                      help="'auto' = the scale of the device (honours BENCH_CONFIG, BENCH_TUNED_PRESET and "
                      "BENCH_SMOKE), "
                      "'smoke' / 'cpu' = the reduced scales, 1..5 = a BASELINE preset, or a "
                      "tuned_preset.json path.")
    warm.add_argument("--jobs", type=int, default=4, metavar="N",
                      help="Kernel builds (nvcc) in parallel threads; the programs then run one "
                      "after another on the card.")
    warm.add_argument("--programs", default=None, metavar="SUBSTR[,SUBSTR...]",
                      help="Only the programs whose name holds one of these substrings.")
    warm.add_argument("--device", default=None,
                      help="Torch device (default cuda; the CPU for the 'cpu' target).")
    warm.set_defaults(fn=cmd_warm)

    fit = sub.add_parser(
        "fit",
        help="Memory pre-flight of a plan (learner state + ring + each hot program's measured "
        "peak) against the card's memory; exit 0 fits / 1 over / 2 no limit known.",
    )
    fit.add_argument("target", nargs="?", default="auto",
                     help="As `warm`'s: auto, smoke, cpu, 1..5, or a tuned_preset.json path.")
    fit.add_argument("--limit-gb", type=float, default=None, metavar="GIB",
                     help="Per-device limit in GiB (also: ALPHATRIANGLE_DEVICE_BYTES_LIMIT, "
                     "bytes); default: the card's memory.")
    fit.add_argument("--device", default=None,
                     help="Torch device (default cuda; the CPU for the 'cpu' target).")
    fit.add_argument("--json", action="store_true", help="Emit the report as JSON.")
    fit.add_argument("--serve", action="store_true",
                     help="Also measure a serve dispatch at the plan's slot count.")
    fit.add_argument("--programs", default=None, metavar="SUBSTR[,SUBSTR...]",
                     help="Only measure the programs whose name holds one of these substrings "
                     "(the learner state and the ring are always counted).")
    fit.set_defaults(fn=cmd_fit)

    mem = sub.add_parser(
        "mem",
        help="A run's memory-attribution table from its metrics.jsonl alone (no torch).",
    )
    mem.add_argument("run", nargs="?", default=None,
                     help="Run name, run directory or metrics.jsonl path (default: the newest run).")
    mem.add_argument("--root-dir", default=None)
    mem.add_argument("--json", action="store_true", help="Emit records + budget as JSON.")
    mem.set_defaults(fn=cmd_mem)

    roofline = sub.add_parser(
        "roofline",
        help="A run's roofline report: each program's intensity against the card's balance, and "
        "the gaps between dispatches, from its files alone (no torch).",
    )
    roofline.add_argument("run", nargs="?", default=None,
                          help="Run name, run directory or metrics.jsonl path (default: the "
                          "newest run).")
    roofline.add_argument("--root-dir", default=None)
    roofline.add_argument("--json", action="store_true", help="Emit the summary as one JSON line.")
    roofline.set_defaults(fn=cmd_roofline)

    tune = sub.add_parser(
        "tune",
        help="Measured-fit autotuner: search batch/capacity/chunk/K/dp/geometry for the feasible "
        "config of highest predicted games/h (each candidate's programs run once on the device, "
        "their allocator peaks the oracle) and write a tuned_preset.json; exit 0 a winner / 1 none "
        "fits / 2 no limit known.",
    )
    tune.add_argument("target", nargs="?", default="auto",
                      help="Base scale to search around, as `warm`'s: auto, smoke, cpu, 1..5, or a "
                      "tuned_preset.json path.")
    tune.add_argument("--limit-gb", type=float, default=None, metavar="GIB",
                      help="Per-device byte limit (GiB) to fit under (default: the card's memory; "
                      "also ALPHATRIANGLE_DEVICE_BYTES_LIMIT, bytes).")
    tune.add_argument("--smoke", action="store_true",
                      help="A two-candidate lattice: one or two oracle runs, not a sweep.")
    tune.add_argument("--json", action="store_true",
                      help="Emit the search report (rows, winner, oracle calls) as JSON.")
    tune.add_argument("--out", default=None, metavar="PATH",
                      help="Write tuned_preset.json here (default: runs/<run-name>/tuned_preset.json).")
    tune.add_argument("--run-name", default=None)
    tune.add_argument("--root-dir", default=None)
    tune.add_argument("--batches", default=None,
                      help="Override the SELF_PLAY_BATCH_SIZE axis (comma-separated).")
    tune.add_argument("--capacities", default=None,
                      help="Override the BUFFER_CAPACITY axis (comma-separated).")
    tune.add_argument("--chunks", default=None,
                      help="Override the rollout chunk T axis (comma-separated).")
    tune.add_argument("--fused-k", default=None,
                      help="Override the fused learner K axis (comma-separated).")
    tune.add_argument("--dp", default=None,
                      help="Override the data-parallel axis (comma-separated).")
    tune.add_argument("--geometries", default=None,
                      help="Board geometries to search (comma-separated names of "
                      "config.presets.GEOMETRY_PRESETS, or 'plan' = the scale's board).")
    tune.add_argument("--kernel-backends", default=None, metavar="BACKENDS",
                      help="Mode strings to search for backup_update and PER_SAMPLE_BACKEND "
                      "(comma-separated from xla,pallas). On the card every mode launches the same "
                      "hand-written kernel; the axis shares oracle answers. Default: xla only.")
    tune.add_argument("--precisions", default=None, metavar="DTYPES",
                      help="INFERENCE_PRECISION values to search (comma-separated from "
                      "float32,bfloat16,int8). Default: float32 only.")
    tune.add_argument("--serve-buckets", action="append", default=None, metavar="RUNGS",
                      help="Serve-shape ladders to search (repeatable; a CSV rung list like "
                      "64,256,1024, or 'off'). Shares oracle answers. Default: off only.")
    tune.add_argument("--tree-reuse", default=None, metavar="VALUES",
                      help="Subtree-reuse settings to search (comma-separated from off,on); 'on' "
                      "widens the tree planes, so it gets oracle answers of its own. Default: off.")
    tune.add_argument("--calibrate", action="append", default=None, metavar="RUN_OR_JSON",
                      help="Calibrate the throughput model against these runs or perf summaries "
                      "(repeatable; anything `cli compare` reads). Default: the model's constants.")
    tune.add_argument("--mode", default="auto", choices=["auto", "sync", "megastep"],
                      help="Loop being tuned (auto = the megastep where the plan keeps its ring on "
                      "the device).")
    tune.add_argument("--device", default=None, choices=["auto", "cuda", "cpu"],
                      help="Device the oracle runs on (auto = the card; default: the CPU for the "
                      "'cpu' target, else the card).")
    tune.set_defaults(fn=cmd_tune)

    play = sub.add_parser("play", help="Interactive text play on the default board.")
    play.add_argument("--seed", type=int, default=0)
    play.add_argument("--engine", choices=["auto", "native", "jax"], default="auto",
                      help="native = the host engine (env/native/, built with g++); jax = the "
                      "port's GameState engine on --device (the JAX command line's name); auto = "
                      "native where it builds.")
    play.add_argument("--script", default=None,
                      help="Semicolon-separated scripted moves ('0 0 0;1 2 3'); plays them, then "
                      "exits.")
    play.add_argument("--device", default=None,
                      help="Torch device of the GameState engine (default cuda).")
    play.set_defaults(fn=cmd_play)

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

    lint = sub.add_parser(
        "lint",
        help="graftlint: AST-based analyzer of the port's eager-PyTorch hazards (in-place reads, host "
        "syncs, placement, flight coverage, debug artifacts, RNG, exits); no torch import; exit 0 "
        "clean / 1 findings / 2 parse error.",
    )
    lint.add_argument("path", nargs="?", default=None,
                      help="Tree to lint (default: the alphatriangle_tpu_torch package).")
    lint.add_argument("--rule", action="append", default=None, metavar="NAME",
                      help="Run only this rule (repeatable).")
    lint.add_argument("--baseline", default=None, metavar="PATH",
                      help=f"Baseline file of grandfathered finding keys (default: {LINT_BASELINE} inside "
                      "the linted tree). Stale entries fail the lint.")
    lint.add_argument("--write-baseline", action="store_true",
                      help="Grandfather every current finding into the baseline file and exit 0.")
    lint.add_argument("--json", action="store_true",
                      help='One-line JSON verdict (leads with "schema": "alphatriangle.lint.v1").')
    lint.set_defaults(fn=cmd_lint)
    return parser


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
