"""Command line of the PyTorch port: counterpart of
`alphatriangle_tpu/cli.py`'s `serve` and `train` subcommands.

    python -m alphatriangle_tpu_torch.cli serve [--slots 64] [--sims 64]
        [--sessions 96] [--max-moves 200] [--seed 0] [--device cuda]
        [--state-dict PATH]

Serves simulated sessions through `PolicyService` over the default
board and net: an untrained net (seed 0) or a state dict written by
`torch.save(flax_to_torch(variables), PATH)`. Prints one JSON report.

    python -m alphatriangle_tpu_torch.cli train
        [--async-rollouts [--workers N] [--replay-ratio R] | --fused-megastep]
        [--device-replay {auto,on,off}] [--max-steps N] [--self-play-batch B]
        [--batch-size B] [--buffer-capacity N] [--min-buffer N]
        [--rollout-chunk T] [--fused-learner-steps K] [--seed S] [--device cuda]

Trains the default board and net through `run_training`: the
synchronous loop without a mode flag, the overlapped loop (producer
threads behind a replay-ratio gate) with `--async-rollouts`, the fused
megastep with `--fused-megastep`. Prints one JSON report: steps, losses,
rows ingested, episodes, weight syncs, the achieved replay ratio and
timings.
"""

import argparse
import json
import sys
import time


def cmd_serve(args: argparse.Namespace) -> int:
    import torch

    from .config import AlphaTriangleMCTSConfig, EnvConfig, ModelConfig
    from .device import resolve_device
    from .env import TriangleEnv
    from .features import FeatureExtractor
    from .mcts import BatchedMCTS
    from .nn import NeuralNetwork
    from .serving import PolicyService, run_simulated_load

    def say(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    device = resolve_device(args.device)
    env_cfg, model_cfg = EnvConfig(), ModelConfig()
    mcts_cfg = AlphaTriangleMCTSConfig(max_simulations=args.sims)
    env = TriangleEnv(env_cfg, device=device)
    extractor = FeatureExtractor(env, model_cfg)
    state_dict = None
    source = "untrained"
    if args.state_dict:
        state_dict = torch.load(args.state_dict, map_location="cpu", weights_only=True)
        source = args.state_dict
    net = NeuralNetwork(model_cfg, env_cfg, seed=0, state_dict=state_dict, device=device)
    mcts = BatchedMCTS(env, extractor, net.model, mcts_cfg, net.support)
    service = PolicyService(env, extractor, net, mcts, slots=args.slots, rng_seed=args.seed)
    say(
        f"serve: {source} net, board {env_cfg.ROWS}x{env_cfg.COLS}, {args.slots} slots, "
        f"{args.sims} sims/move, device {device}"
    )
    t0 = time.perf_counter()
    stats = run_simulated_load(
        service,
        total_sessions=args.sessions,
        concurrency=args.slots,
        max_moves=args.max_moves,
        seed=args.seed,
        progress=say,
    )
    report = {
        "source": source,
        "device": str(device),
        "slots": args.slots,
        "sims": args.sims,
        "wall_seconds": time.perf_counter() - t0,
        **stats,
        **service.serve_stats(),
    }
    print(json.dumps(report))
    return 0 if stats["sessions_served"] >= args.sessions else 1


def cmd_train(args: argparse.Namespace) -> int:
    from .config import TrainConfig
    from .training import EXIT_CODES, run_training

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
    loop = run_training(TrainConfig(**overrides), device=args.device)
    print(json.dumps(loop.report()))
    return EXIT_CODES[loop.status]


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
    serve.set_defaults(fn=cmd_serve)

    train = sub.add_parser(
        "train",
        help="Self-play training of the default board and net: the synchronous loop "
        "(rollout chunk, ring fold, learner steps per iteration) unless a mode flag is given.",
    )
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
    train.add_argument("--device", default="cuda",
                       help="Torch device (default cuda; 'cpu' runs the plain versions).")
    train.set_defaults(fn=cmd_train)
    return parser


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
