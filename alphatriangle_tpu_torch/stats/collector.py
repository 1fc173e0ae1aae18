"""In-process metric aggregation: counterpart of
`alphatriangle_tpu/stats/collector.py` (`StatsCollector`).

Subsystems fire events at any rate and from any thread (`log_event`,
`log_batch_events`, `log_scalar`: a lock-guarded append, off the device
path). Aggregation and I/O happen only on a tick (`process_and_log`):
the mean of each metric's pending values, written at the tick's step.
Non-finite values are dropped from the means, counted per name, warned
once per name and reported as one cumulative `Stats/nonfinite_dropped`
scalar on each tick.

Writers: `live_metrics.jsonl` in the run directory, unless
`use_live_file` is off (a dp run's ranks but the first; one JSON line per tick, `{"step", "time", "means"}`, the JAX package's format,
read by its `cli watch`); TensorBoard through `torch.utils.tensorboard`
when asked and when that module imports (where TensorFlow is installed,
the import alone takes seconds). `writers` names the ones the collector
opened. A tick sink (`set_tick_sink`) gets every tick's means: a
training run's metrics ledger. MLflow stays out, as in the JAX package
where the package is absent.
"""

import atexit
import json
import logging
import math
import threading
import time
from collections import defaultdict, deque
from pathlib import Path

import numpy as np

from ..config.persistence_config import PersistenceConfig
from .events import RawMetricEvent

logger = logging.getLogger(__name__)

# Tick means kept in memory per metric (`get_series`, `latest`).
HISTORY_LIMIT = 1024


def summary_writer_cls():
    """`torch.utils.tensorboard.SummaryWriter`, or None where it does not
    import; looked up when a collector is built."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter


class StatsCollector:
    """Aggregates raw metric events; writes the means of each tick."""

    def __init__(
        self,
        persistence: "PersistenceConfig | None" = None,
        use_tensorboard: bool = True,
        use_live_file: bool = True,
    ):
        self._lock = threading.Lock()
        self._pending: dict[str, list[tuple[int, float]]] = defaultdict(list)
        self._nonfinite: dict[str, int] = defaultdict(int)
        self._nonfinite_warned: set[str] = set()
        self._history: dict[str, deque] = defaultdict(lambda: deque(maxlen=HISTORY_LIMIT))
        self._writer = None
        if use_tensorboard and persistence is not None:
            writer_cls = summary_writer_cls()
            if writer_cls is None:
                logger.info("TensorBoard is not installed; writing live_metrics.jsonl only.")
            else:
                tb_dir = persistence.get_tensorboard_dir()
                tb_dir.mkdir(parents=True, exist_ok=True)
                self._writer = writer_cls(str(tb_dir))
        self._live_path: "Path | None" = None
        if persistence is not None and use_live_file:
            base = persistence.get_run_base_dir()
            base.mkdir(parents=True, exist_ok=True)
            self._live_path = base / "live_metrics.jsonl"
        self.writers = (["live_metrics"] if self._live_path is not None else []) + (
            ["tensorboard"] if self._writer is not None else []
        )
        # Optional durable sink, called with (step, means) after every
        # processed batch: `RunTelemetry.record_metrics`, the metrics
        # ledger, wired in setup.
        self._tick_sink = None
        # Events logged after the last tick land at the newest step seen
        # on close(); an atexit hook covers paths that never call it.
        self._last_event_step = 0
        self._closed = False
        self._atexit_cb = self.close
        atexit.register(self._atexit_cb)

    @property
    def live_path(self) -> "Path | None":
        return self._live_path

    def set_tick_sink(self, sink) -> None:
        """Attach a callable(step, means) invoked after each tick."""
        self._tick_sink = sink

    # --- ingestion (cheap, any thread) ------------------------------------

    def log_event(self, event: RawMetricEvent) -> None:
        if not math.isfinite(event.value):
            with self._lock:
                self._nonfinite[event.name] += 1
                first = event.name not in self._nonfinite_warned
                if first:
                    self._nonfinite_warned.add(event.name)
            if first:
                logger.warning(
                    "Non-finite value for metric %s at step %d; dropping "
                    "(further drops counted in Stats/nonfinite_dropped).",
                    event.name,
                    event.global_step,
                )
            return
        with self._lock:
            self._pending[event.name].append((event.global_step, event.value))
            if event.global_step > self._last_event_step:
                self._last_event_step = event.global_step

    def log_batch_events(self, events: list[RawMetricEvent]) -> None:
        for e in events:
            self.log_event(e)

    def log_scalar(self, name: str, value: float, step: int = 0) -> None:
        """Log a bare scalar without building an event."""
        self.log_event(RawMetricEvent(name=name, value=value, global_step=step))

    # --- aggregation ticks ------------------------------------------------

    def process_and_log(self, global_step: int) -> dict[str, float]:
        """Flush the pending events: the mean of each metric, written at
        `global_step`. Returns the means (name -> mean)."""
        with self._lock:
            pending, self._pending = self._pending, defaultdict(list)
            dropped = sum(self._nonfinite.values())
        if dropped:
            pending["Stats/nonfinite_dropped"].append((global_step, float(dropped)))
        means: dict[str, float] = {}
        for name, obs in pending.items():
            if not obs:
                continue
            mean = float(np.mean([v for _, v in obs]))
            means[name] = mean
            self._history[name].append((global_step, mean))
            if self._writer is not None:
                self._writer.add_scalar(name, mean, global_step)
        if self._writer is not None and means:
            self._writer.flush()
        if self._live_path is not None and means:
            try:
                with self._live_path.open("a") as f:
                    f.write(json.dumps({"step": global_step, "time": time.time(), "means": means}) + "\n")
            except OSError:  # observability is never fatal
                logger.exception("live-metrics append failed")
        if self._tick_sink is not None and means:
            try:
                self._tick_sink(global_step, means)
            except Exception:  # the durable sink is best-effort too
                logger.exception("metrics tick sink failed")
        return means

    def force_process_and_log(self, global_step: int) -> dict[str, float]:
        """The final flush of a run."""
        return self.process_and_log(global_step)

    # --- experiment parameters ----------------------------------------------

    def log_params(self, configs: dict[str, object]) -> None:
        """Each config as one markdown text card in TensorBoard."""
        if self._writer is None:
            return
        for name, cfg in configs.items():
            payload = cfg.model_dump() if hasattr(cfg, "model_dump") else cfg
            text = "```json\n" + json.dumps(payload, indent=2, default=str) + "\n```"
            self._writer.add_text(f"config/{name}", text, 0)
        self._writer.flush()

    # --- introspection ----------------------------------------------------

    def get_series(self, name: str) -> list[tuple[int, float]]:
        """The (step, mean) history of one metric."""
        return list(self._history.get(name, []))

    def latest(self, name: str) -> "float | None":
        series = self._history.get(name)
        return series[-1][1] if series else None

    def nonfinite_dropped(self) -> dict[str, int]:
        """Cumulative non-finite drop count per metric name."""
        with self._lock:
            return dict(self._nonfinite)

    def close(self) -> None:
        """Flush what is pending at the newest step seen and close the
        TensorBoard writer; idempotent."""
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self._atexit_cb)
        with self._lock:
            has_pending = any(self._pending.values())
            step = self._last_event_step
        if has_pending:
            try:
                self.process_and_log(step)
            except Exception:
                logger.exception("final stats flush failed")
        if self._writer is not None:
            self._writer.close()
            self._writer = None
