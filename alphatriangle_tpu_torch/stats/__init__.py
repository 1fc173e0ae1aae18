"""Metric events and their collector; checkpoints, buffer spills and
restores of a training run; the live-run console's readers
(`stats/watch.py`).

The exports resolve lazily (PEP 562): the collector needs numpy and the
checkpoints torch, while `stats/watch.py` is read by `cli watch`, which
runs beside a training process without either.
"""

_LAZY = {
    "StatsCollector": ".collector",
    "RawMetricEvent": ".events",
    "CheckpointManager": ".persistence",
    "LoadedTrainingState": ".persistence",
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
