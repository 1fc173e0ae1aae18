"""Command line of the PyTorch port: counterpart of
`alphatriangle_tpu/cli.py`'s `serve` subcommand.

    python -m alphatriangle_tpu_torch.cli serve [--slots 64] [--sims 64]
        [--sessions 96] [--max-moves 200] [--seed 0] [--device cuda]
        [--state-dict PATH]

Serves simulated sessions through `PolicyService` over the default
board and net: an untrained net (seed 0) or a state dict written by
`torch.save(flax_to_torch(variables), PATH)`. Prints one JSON report.
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
    return parser


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
