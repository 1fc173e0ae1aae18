"""Simulated concurrent-session load for the policy service:
counterpart of `alphatriangle_tpu/serving/loadgen.py`.

Drives N simulated game sessions through the continuous batcher with
churn: sessions retire as their games end and replacements are admitted
mid-run. Deterministic given (seed, slot count, traffic shape): reset
keys come from a counted key chain and admission is lowest-free-slot.
"""

import logging
import time

import torch

from .. import rng

logger = logging.getLogger(__name__)


def run_simulated_load(
    service,
    total_sessions: int,
    concurrency: "int | None" = None,
    max_moves: int = 200,
    seed: int = 0,
    max_dispatches: "int | None" = None,
    reload_hook=None,
    progress=None,
    progress_every: int = 8,
    clock=time.monotonic,
    tick_every: "int | None" = None,
) -> dict:
    """Serve `total_sessions` games end to end, keeping up to
    `concurrency` live at once (default: every slot).

    `reload_hook(service, dispatch_count)` runs between dispatches;
    `max_dispatches` bounds the run (live sessions are then closed).
    `tick_every` (`cli serve --tick-every`) ticks the service's telemetry
    every that many dispatches, as the JAX load generator does (`cli
    serve` ticks once more at the end); None, the default here, never
    ticks, so a caller that reads the service's whole window keeps it.
    Returns the run's summary stats.
    """
    # Bounded by the most sessions the service can ever hold (its ladder's
    # top rung): demand above the current width is what walks it up.
    concurrency = min(concurrency or service.sessions.slots, service.max_slots)
    if concurrency < 1:
        raise ValueError("concurrency must be >= 1")
    t_start = clock()
    key_counter = 0
    base_key = rng.PRNGKey(seed)

    def next_keys(n: int) -> torch.Tensor:
        nonlocal key_counter
        keys = rng.fold_in(base_key, torch.arange(key_counter, key_counter + n))
        key_counter += n
        return keys

    def admit_up_to_target() -> None:
        want = min(
            concurrency - service.sessions.live_count,
            total_sessions - service.sessions.admitted_total,
            service.sessions.free_count,
        )
        if want > 0:
            for s in service.open_sessions(next_keys(want)):
                service.request_move(s.sid)

    admit_up_to_target()
    dispatches = 0
    served_moves = 0
    retired = []
    while service.sessions.live_count > 0:
        results = service.dispatch()
        dispatches += 1
        served_moves += len(results)
        for r in results:
            if r["done"] or r["move"] >= max_moves:
                retired.append(service.close_session(r["sid"]))
            else:
                service.request_move(r["sid"])
        admit_up_to_target()
        if tick_every and dispatches % tick_every == 0:
            service.tick()
        if reload_hook is not None:
            reload_hook(service, dispatches)
        if progress is not None and dispatches % progress_every == 0:
            progress(
                f"serve: {len(retired)}/{total_sessions} sessions done, "
                f"{served_moves} moves, {service.sessions.live_count} live, "
                f"dispatch {dispatches}"
            )
        if max_dispatches is not None and dispatches >= max_dispatches:
            logger.warning(
                "loadgen: max_dispatches=%d reached with %d live session(s); truncating",
                max_dispatches,
                service.sessions.live_count,
            )
            for s in list(service.sessions.live_sessions()):
                retired.append(service.close_session(s.sid))
            break
    elapsed = clock() - t_start
    scores = [r["score"] for r in retired]
    return {
        "sessions_served": len(retired),
        "sessions_finished": sum(1 for r in retired if r["done"]),
        "moves_served": served_moves,
        "dispatches": dispatches,
        "seconds": elapsed,
        "moves_per_sec": served_moves / max(elapsed, 1e-9),
        "mean_score": (float(sum(scores)) / len(scores)) if scores else None,
        "max_concurrency": concurrency,
        "weight_reloads": service.weight_reloads,
    }
