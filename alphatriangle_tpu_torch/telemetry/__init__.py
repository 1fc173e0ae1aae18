"""Run telemetry: counterpart of `alphatriangle_tpu/telemetry/`, with the
parts a serve run and the serve fleet use.

`RunTelemetry` bundles, behind one facade a `PolicyService` talks to:

- `tracer.SpanTracer`: wall-clock spans exported to `trace.json`;
- `health.HealthMonitor` + `health.Watchdog`: the `health.json`
  heartbeat and the stall watchdog;
- `ledger.MetricsLedger` + `perf.UtilizationMeter`: one derived
  `kind: "util"` record per tick appended to `metrics.jsonl`;
- `flight.FlightRecorder` + `flight.DispatchWatchdog`: the intent/seal
  ring of every bracketed dispatch and its deadline watchdog, which
  exits 113 on a wedge.

Every module of the package is stdlib only, apart from the lazy torch
import of `health.device_memory_stats`: the fleet parent reads ledgers,
heartbeats and flight rings without loading torch. The anomaly
detector, the device stat-packs and beacons, and the memory and compile
records are not ported yet.
"""

import logging
import time
from pathlib import Path

from ..config.telemetry_config import TelemetryConfig
from . import tracectx
from .flight import FLIGHT_FILENAME, DispatchWatchdog, FlightRecorder
from .health import HealthMonitor, Watchdog, device_memory_stats, dump_thread_stacks
from .ledger import METRICS_FILENAME, MetricsLedger
from .perf import UtilizationMeter
from .tracer import SpanTracer

logger = logging.getLogger(__name__)

__all__ = [
    "DispatchWatchdog",
    "FlightRecorder",
    "HealthMonitor",
    "MetricsLedger",
    "RunTelemetry",
    "SpanTracer",
    "TelemetryConfig",
    "UtilizationMeter",
    "Watchdog",
]

TRACE_FILENAME = "trace.json"
HEALTH_FILENAME = "health.json"
STACKS_FILENAME = "stall_stacks.txt"


class RunTelemetry:
    """One run's telemetry: tracer, heartbeat and stall watchdog, ledger
    and meter, flight recorder and dispatch watchdog.

    `start()` when serving begins, `on_rollout` as requests are served
    (O(1), any thread), `on_util_tick` / `on_tick` once per tick (the
    only places with IO), `close()` at the end."""

    def __init__(
        self,
        config: TelemetryConfig | None = None,
        run_dir: Path | str = ".",
        run_name: str = "",
        clock=time.monotonic,
        perf: UtilizationMeter | None = None,
    ) -> None:
        self.config = config or TelemetryConfig()
        self.run_dir = Path(run_dir)
        self.run_name = run_name
        self.tracer = SpanTracer()
        self.health = HealthMonitor(self.run_dir / HEALTH_FILENAME, run_name=run_name, clock=clock)
        self.perf = perf
        self.ledger = MetricsLedger(self.run_dir / METRICS_FILENAME)
        if perf is not None:
            self.health.set_device_info(perf.device_kind, perf.peak_tflops, perf.peak_source)
        self.watchdog = Watchdog(
            self.health, deadline_s=self.health.deadline_s, on_stall=self._on_stall, clock=clock
        )
        self.dispatch_watchdog = DispatchWatchdog(
            self.run_dir,
            poll_s=self.config.DISPATCH_WATCHDOG_POLL_S,
            on_wedge=self._on_wedge,
            clock=clock,
        )
        # A spawning parent's trace context (the env seam) becomes the
        # ring's base trace, linking every dispatch here back to the
        # spawn event.
        parent_ctx = tracectx.from_env()
        self.flight = FlightRecorder(
            self.run_dir / FLIGHT_FILENAME,
            min_deadline_s=self.config.DISPATCH_MIN_DEADLINE_S,
            first_deadline_s=self.config.DISPATCH_FIRST_DEADLINE_S,
            watchdog=self.dispatch_watchdog,
            base_trace=parent_ctx.fields() if parent_ctx is not None else None,
        )
        self._step = 0
        self._last_write_mono = None
        self._last_written_step: int | None = None
        self._clock = clock
        self._closed = False

    def start(self) -> None:
        self.watchdog.start()
        self.dispatch_watchdog.start()

    def close(self, step: int | None = None) -> None:
        """Stop the watchdogs; write the flight ring's overhead record,
        the final heartbeat and the span trace."""
        if self._closed:
            return
        self._closed = True
        self.watchdog.stop()
        self.dispatch_watchdog.stop()
        self.flight.close()
        if step is not None:
            self._step = step
        self.health.write()
        n = self.tracer.export(self.run_dir / TRACE_FILENAME)
        logger.info(
            "Telemetry: %d span(s) -> %s, heartbeat -> %s",
            n, self.run_dir / TRACE_FILENAME, self.health.path,
        )

    def on_rollout(self, experiences: int = 0, episodes: int = 0) -> None:
        self.health.note_rollout(experiences, episodes)

    def on_util_tick(self, step: int, **counters) -> "dict | None":
        """Derive and ledger one utilization record from the caller's
        cumulative counters (`UtilizationMeter.tick`'s keys); the card's
        memory is read here. Returns the record."""
        if self.perf is None:
            return None
        if "device_memory" not in counters:
            counters["device_memory"] = device_memory_stats()
        record = self.perf.tick(step, **counters)
        if record is None:
            return None
        self.ledger.append(record)
        self.health.note_utilization(record)
        return record

    def on_tick(self, step: int, buffer_size: int = 0) -> None:
        """Write the heartbeat when the step moved or the interval passed."""
        self._step = step
        self.health.note_buffer(buffer_size)
        now = self._clock()
        due = (
            self._last_write_mono is None
            or step != self._last_written_step
            or now - self._last_write_mono >= self.config.HEALTH_WRITE_INTERVAL_S
        )
        if due:
            self._last_write_mono = now
            self._last_written_step = step
            self.health.write()

    def _on_stall(self, age_s: float) -> None:
        """Stall watchdog hook: stacks, an instant span, the trace and
        the heartbeat on disk."""
        dump_thread_stacks(self.run_dir / STACKS_FILENAME)
        self.tracer.instant("watchdog_stall", age_s=round(age_s, 1))
        self.tracer.export(self.run_dir / TRACE_FILENAME)
        self.health.write()
        logger.warning(
            "Watchdog: thread stacks -> %s, span trace -> %s",
            self.run_dir / STACKS_FILENAME, self.run_dir / TRACE_FILENAME,
        )

    def _on_wedge(self, info: dict) -> None:
        """Dispatch watchdog hook, before wedge_report.json and the exit:
        the trace into the wedge goes to disk. No heartbeat write: it
        reads the card's memory, and a wedged card could hang it."""
        self.tracer.instant(
            "dispatch_wedge", program=info.get("program"), elapsed_s=info.get("elapsed_s")
        )
        self.tracer.export(self.run_dir / TRACE_FILENAME)
        self.health.set_stalled(True)
