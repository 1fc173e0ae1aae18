"""One serve-fleet replica: a `PolicyService` behind a pipe protocol,
counterpart of `alphatriangle_tpu/serving/replica.py`.

Each replica is a subprocess (`python -m
alphatriangle_tpu_torch.serving.replica`) hosting one `PolicyService` on
the card, in its own CUDA context, with its own run directory
(heartbeat, flight ring, metrics ledger), spoken to over JSON lines on
stdin/stdout by the torch-free fleet parent (`serving/fleet.py`). The
process boundary is the point: a wedged or killed replica takes down
one service, and the router re-routes.

Protocol (one JSON object per line; `id` echoes back):

    {"id": N, "kind": "episode", "seed": S, "max_moves": M}
        -> {"id": N, "ok": true, "moves": m, "done": d, "score": s,
            "lat_ms": [per-move latency]}
        Plays one game through the service (idempotent given the seed:
        safe to retry or hedge on another replica).
    {"id": N, "kind": "ping"}     -> liveness + queue depth
    {"id": N, "kind": "stats"}    -> serve_stats + the kernel library counts
    {"id": N, "kind": "reload"}   -> hot weight reload; `recompiles` is the
        number of kernel libraries the reload built or loaded (0)
    {"id": N, "kind": "shutdown"} -> ack, then clean exit

Stdout is the wire: `main` keeps a private handle to it for the replies
and points file descriptor 1 and `sys.stdout` at stderr, so nothing
else the process prints reaches the parent's parser.

Threads: the main thread reads stdin and answers control requests; a
dispatcher thread batches every active episode's pending move into one
`dispatch()` (the micro-batching contract); a heartbeat thread keeps
`health.json` fresh while idle, so the parent's probe gates admission
on liveness, not traffic. A `hang-serve` fault wedges the dispatcher
inside its flight bracket: the in-process DispatchWatchdog exits 113,
and the unsealed `serve/b<B>` intent is the evidence the fleet's
diagnosis reads.
"""

import argparse
import json
import logging
import os
import sys
import threading
import time

from ..telemetry import tracectx

logger = logging.getLogger(__name__)

READY_KIND = "ready"


def _clock_pair() -> dict:
    """This process's `(monotonic, wall)` clock sample, stamped on the
    ready and ping replies so a fleet trace merge can place this
    process's monotonic clock on the shared wall clock."""
    return {"t_mono": time.monotonic(), "time": time.time()}


def kernel_libraries() -> tuple[int, int]:
    """(kernel libraries this process has loaded, `nvcc` builds it
    ran): the port's counterpart of the JAX compile cache's misses and
    events. A weight reload changes neither: the kernels read the
    weights as arguments, so `recompiles` is the change of the first."""
    from ..ops import KERNELS

    kernels = KERNELS.values()
    return sum(k.loaded for k in kernels), sum(k.builds for k in kernels)


class _Episode:
    __slots__ = (
        "req_id", "sid", "seed", "max_moves", "moves", "lat_ms",
        "trace", "t0_ns",
    )

    def __init__(self, req_id, sid, seed, max_moves, trace=None):
        self.req_id = req_id
        self.sid = sid
        self.seed = seed
        self.max_moves = max_moves
        self.moves = 0
        self.lat_ms: list = []
        # Trace-context fields of the routed request driving this
        # episode (telemetry/tracectx.py); empty for legacy callers.
        self.trace: dict = trace or {}
        self.t0_ns = time.time_ns()


class ReplicaServer:
    """Protocol loop around one PolicyService (built by `main`)."""

    def __init__(self, service, telemetry, tick_every: int = 8, out=None):
        self.service = service
        self.telemetry = telemetry
        self.tick_every = tick_every
        self.out = out or sys.stdout
        self._out_lock = threading.Lock()
        self._active: dict[int, _Episode] = {}  # sid -> episode
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._dispatches_since_tick = 0

    # --- wire -----------------------------------------------------------

    def reply(self, payload: dict) -> None:
        with self._out_lock:
            self.out.write(json.dumps(payload) + "\n")
            self.out.flush()

    # --- dispatcher thread ----------------------------------------------

    def _finish(self, ep: _Episode, ok: bool, error: str | None = None):
        try:
            summary = self.service.close_session(ep.sid)
        except Exception:
            summary = {}
        done = bool(summary.get("done"))
        # The episode's lane in this replica's trace.json: one complete
        # span from request arrival to reply, carrying the routed
        # request's trace ids so the fleet merge can draw the
        # router -> replica flow arrow.
        tracer = getattr(self.telemetry, "tracer", None)
        if tracer is not None:
            tracer.complete(
                "replica/episode",
                ep.t0_ns,
                time.time_ns(),
                moves=ep.moves,
                ok=ok,
                **ep.trace,
            )
        self.reply(
            {
                "id": ep.req_id,
                "ok": ok,
                "kind": "episode",
                "seed": ep.seed,
                "moves": ep.moves,
                "done": done,
                "score": summary.get("score"),
                "lat_ms": [round(v, 3) for v in ep.lat_ms],
                **ep.trace,
                **({"error": error} if error else {}),
            }
        )

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                while not self._active and not self._stop.is_set():
                    self._cond.wait(timeout=0.2)
                if self._stop.is_set():
                    return
            try:
                results = self.service.dispatch()
            except Exception as exc:
                # A dispatch that raises (e.g. the crash-serve fault)
                # sealed its flight bracket ok:false; the sessions it
                # was serving are in an undefined mid-wave state, so
                # fail them back to the router (which retries them on
                # another replica) and keep serving.
                logger.exception("dispatch failed; failing active episodes")
                with self._cond:
                    failed, self._active = dict(self._active), {}
                for ep in failed.values():
                    self._finish(ep, ok=False, error=f"dispatch: {exc}")
                continue
            finished: list = []
            with self._cond:
                for r in results:
                    ep = self._active.get(r["sid"])
                    if ep is None:
                        continue
                    ep.moves += 1
                    ep.lat_ms.append(float(r["latency_ms"]))
                    if r["done"] or ep.moves >= ep.max_moves:
                        finished.append(ep)
                        del self._active[ep.sid]
                    else:
                        self.service.request_move(ep.sid)
            for ep in finished:
                self._finish(ep, ok=True)
            if results:
                self._dispatches_since_tick += 1
                if self._dispatches_since_tick >= self.tick_every:
                    self._dispatches_since_tick = 0
                    try:
                        self.service.tick()
                    except Exception:
                        logger.exception("serve tick failed (continuing)")

    # --- heartbeat thread -----------------------------------------------

    def _heartbeat_loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.telemetry.health.write()
            except Exception:
                logger.exception("heartbeat write failed (continuing)")

    # --- control-plane handlers ------------------------------------------

    def _handle(self, req: dict) -> bool:
        """Process one request; returns False on shutdown."""
        kind = req.get("kind")
        rid = req.get("id")
        if kind == "episode":
            trace = tracectx.trace_fields(req)
            try:
                s = self.service.open_session(seed=int(req.get("seed", 0)))
            except Exception as exc:
                self.reply(
                    {
                        "id": rid,
                        "ok": False,
                        "kind": kind,
                        "error": str(exc),
                        **trace,
                    }
                )
                return True
            set_trace = getattr(self.service, "set_session_trace", None)
            if set_trace is not None and trace:
                set_trace(s.sid, trace)
            # Register BEFORE request_move: the dispatcher may serve
            # the very next wave, and a result for an unregistered sid
            # would be dropped (wedging the episode forever).
            with self._cond:
                self._active[s.sid] = _Episode(
                    rid,
                    s.sid,
                    req.get("seed"),
                    int(req.get("max_moves", 64)),
                    trace=trace,
                )
            try:
                self.service.request_move(s.sid)
            except Exception as exc:
                with self._cond:
                    self._active.pop(s.sid, None)
                try:
                    self.service.close_session(s.sid)
                except Exception:
                    pass
                self.reply(
                    {"id": rid, "ok": False, "kind": kind, "error": str(exc)}
                )
                return True
            with self._cond:
                self._cond.notify()
            return True
        if kind == "ping":
            self.reply(
                {
                    "id": rid,
                    "ok": True,
                    "kind": kind,
                    "pid": os.getpid(),
                    "queue_depth": self.service.queue_depth,
                    "dispatches": self.service.dispatch_count,
                    **_clock_pair(),
                }
            )
            return True
        if kind == "stats":
            loaded, builds = kernel_libraries()
            self.reply(
                {
                    "id": rid,
                    "ok": True,
                    "kind": kind,
                    "cache_misses": loaded,
                    "cache_events": loaded + builds,
                    **self.service.serve_stats(drain=False),
                }
            )
            return True
        if kind == "reload":
            before, _ = kernel_libraries()
            reloads = self.service.reload_weights()
            after, _ = kernel_libraries()
            self.reply(
                {
                    "id": rid,
                    "ok": True,
                    "kind": kind,
                    "reloads": reloads,
                    "cache_misses": after,
                    "recompiles": after - before,
                }
            )
            return True
        if kind == "shutdown":
            self.reply({"id": rid, "ok": True, "kind": kind})
            return False
        self.reply(
            {"id": rid, "ok": False, "error": f"unknown kind {kind!r}"}
        )
        return True

    # --- lifecycle --------------------------------------------------------

    def serve_forever(self, heartbeat_s: float, stdin=None) -> int:
        stdin = stdin or sys.stdin
        threads = [
            threading.Thread(
                target=self._dispatch_loop, name="replica-dispatch", daemon=True
            ),
            threading.Thread(
                target=self._heartbeat_loop,
                args=(heartbeat_s,),
                name="replica-heartbeat",
                daemon=True,
            ),
        ]
        for t in threads:
            t.start()
        try:
            for line in stdin:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                except json.JSONDecodeError:
                    logger.warning("unparseable request line: %r", line[:200])
                    continue
                try:
                    if not self._handle(req):
                        break
                except Exception as exc:
                    logger.exception("request handler failed")
                    self.reply(
                        {"id": req.get("id"), "ok": False, "error": str(exc)}
                    )
        finally:
            self._stop.set()
            with self._cond:
                self._cond.notify_all()
            for t in threads:
                t.join(timeout=5.0)
        return 0


def main(argv: "list | None" = None) -> int:
    p = argparse.ArgumentParser(description="serve-fleet replica worker")
    p.add_argument("--run-dir", required=True, help="this replica's run dir")
    p.add_argument("--configs-dir", default="",
                   help="dir holding configs.json (board/net); the defaults when missing")
    p.add_argument("--name", default="replica")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--buckets", default=None,
                   help="CSV serve-shape ladder (serving/buckets.py); --slots stays the "
                   "starting rung.")
    p.add_argument("--sims", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tick-every", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="Torch device (default cuda; 'cpu' runs the plain versions).")
    p.add_argument("--state-dict", default=None, metavar="PATH",
                   help="Weights from nn/convert.py saved with torch.save "
                   "(default: the untrained net of seed 0).")
    p.add_argument("--health-interval", type=float, default=1.0)
    p.add_argument("--dispatch-min-deadline", type=float, default=60.0)
    p.add_argument("--dispatch-first-deadline", type=float, default=900.0)
    p.add_argument("--dispatch-watchdog-poll", type=float, default=5.0)
    args = p.parse_args(argv)

    # The wire: replies go to a private copy of stdout; fd 1 and
    # sys.stdout now lead to stderr.
    wire = os.fdopen(os.dup(sys.stdout.fileno()), "w", buffering=1)
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    sys.stdout = sys.stderr
    logging.basicConfig(
        level=logging.INFO,
        stream=sys.stderr,
        format=f"%(asctime)s {args.name} %(levelname)s %(message)s",
    )

    from pathlib import Path

    import torch

    from ..config import AlphaTriangleMCTSConfig, TelemetryConfig
    from ..config.run_configs import load_run_configs_or_default
    from ..device import resolve_device
    from ..env import TriangleEnv
    from ..features import FeatureExtractor
    from ..mcts import BatchedMCTS
    from ..nn import NeuralNetwork
    from .service import PolicyService, build_serve_telemetry

    device = resolve_device(args.device)
    run_dir = Path(args.run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    cfg_dir = Path(args.configs_dir) if args.configs_dir else Path("/nonexistent")
    env_cfg, model_cfg = load_run_configs_or_default(cfg_dir)
    mcts_cfg = AlphaTriangleMCTSConfig(max_simulations=args.sims)
    env = TriangleEnv(env_cfg, device=device)
    extractor = FeatureExtractor(env, model_cfg)
    state_dict = None
    if args.state_dict:
        state_dict = torch.load(args.state_dict, map_location="cpu", weights_only=True)
    net = NeuralNetwork(model_cfg, env_cfg, seed=0, state_dict=state_dict, device=device)
    mcts = BatchedMCTS(env, extractor, net.model, mcts_cfg, net.support)

    tele_cfg = TelemetryConfig(
        HEALTH_WRITE_INTERVAL_S=args.health_interval,
        DISPATCH_MIN_DEADLINE_S=args.dispatch_min_deadline,
        DISPATCH_FIRST_DEADLINE_S=args.dispatch_first_deadline,
        DISPATCH_WATCHDOG_POLL_S=args.dispatch_watchdog_poll,
    )
    telemetry = build_serve_telemetry(
        run_dir, args.name, env_cfg, model_cfg, telemetry_config=tele_cfg, device=device
    )
    service = PolicyService(
        env, extractor, net, mcts, slots=args.slots, telemetry=telemetry,
        rng_seed=args.seed, ladder=args.buckets,
    )
    # A search at every rung before the ready line: the first episode's
    # moves then pay neither the library choices nor the kernel loads.
    t0 = time.time()
    service.warm()
    on_card = device.type == "cuda"
    logger.info(
        "warm %s in %.1fs (slots=%d sims=%d)",
        device, time.time() - t0, args.slots, args.sims,
    )
    telemetry.start()
    # The first heartbeat before the ready line: the parent's probe
    # admits on a fresh health.json.
    telemetry.health.write()
    server = ReplicaServer(service, telemetry, tick_every=args.tick_every, out=wire)
    server.reply(
        {
            "kind": READY_KIND,
            "name": args.name,
            "pid": os.getpid(),
            "slots": args.slots,
            "rungs": list(service.ladder.rungs),
            "precision": model_cfg.INFERENCE_PRECISION,
            # True when the warm-up searches ran on the card.
            "warm_aot": on_card,
            "device": torch.cuda.get_device_name(device) if on_card else "cpu",
            **_clock_pair(),
        }
    )
    try:
        return server.serve_forever(heartbeat_s=args.health_interval)
    finally:
        try:
            service.tick()
        except Exception:
            pass
        telemetry.close(step=service.dispatch_count)


if __name__ == "__main__":
    raise SystemExit(main())
