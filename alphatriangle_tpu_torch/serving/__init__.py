"""Policy serving: session slots, the batched service with its bucket
ladder, its load generator, and the serve fleet.

The fleet splits the package in two: `replica.py` hosts one
`PolicyService` per subprocess (torch and the card live there), while
`router.py` and `fleet.py` are the control plane the `cli fleet` parent
runs, which imports neither torch nor numpy, so a wedged card cannot
take it down. The exports are therefore lazy (PEP 562): importing
`serving.fleet` does not import `service`.
"""

_LAZY = {
    "BucketLadder": ".buckets",
    "default_rungs": ".buckets",
    "PolicyService": ".service",
    "build_serve_telemetry": ".service",
    "serve_program_name": ".service",
    "Session": ".session",
    "SessionSlots": ".session",
    "run_simulated_load": ".loadgen",
    "ReplicaRouter": ".router",
    "RouteResult": ".router",
    "FleetSupervisor": ".fleet",
    "run_fleet_load": ".fleet",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(target, __name__), name)


def __dir__() -> list:
    return sorted(set(globals()) | set(_LAZY))
