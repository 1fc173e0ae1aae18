"""Run telemetry: counterpart of `alphatriangle_tpu/telemetry/`, with the
parts a training run, a league run, a serve run and the serve fleet use.

`RunTelemetry` bundles, behind one facade the training loop and a
`PolicyService` talk to:

- `tracer.SpanTracer`: wall-clock spans exported to `trace.json`;
- `health.HealthMonitor` + `health.Watchdog`: the `health.json`
  heartbeat and the stall watchdog;
- `anomaly.AnomalyDetector`: a streaming screen of every learner step's
  losses, gradient norm and entropy (spikes, non-finite values, entropy
  collapse) and of the card's memory per tick (monotonic growth),
  escalated to `Anomaly/*` metrics and warnings;
- `ledger.MetricsLedger` + `perf.UtilizationMeter`: the collector's
  processed metric batches and one derived `kind: "util"` record per
  tick appended to `metrics.jsonl`;
- `flight.FlightRecorder` + `flight.DispatchWatchdog`: the intent/seal
  ring of every bracketed dispatch and its deadline watchdog, which
  warns once per dispatch past half its deadline
  (`_on_dispatch_warn` arms the progress beacons) and exits 113 on a
  wedge;
- `device_stats`: the stat-pack legs each iteration or serve tick folds
  (`record_device_stats`, one `kind: "device_stats"` ledger record,
  screened by `AnomalyDetector.observe_search`) and the progress
  beacons, whose rows go to the run's `beacons.jsonl`;
- `memory` and `roofline`: the static memory records setup ledgers
  (`record_memory`: the learner state, the replay ring) and the program
  records the process's kernel build cache holds (`compile_cache.py`:
  measured memory records, analytic `kind: "cost"` records), drained
  into the ledger once each at every util tick and at close; the util
  record's `compile_hits` / `compile_misses` are the build cache's.

With `TelemetryConfig.ENABLED` false every hook is a no-op and no file
is written. Every module of the package is stdlib only, apart from the
lazy torch imports of `health.device_memory_stats` and of the memory
and cost writers: `cli health`, `cli perf`, `cli mem`, `cli roofline`
and the fleet parent read ledgers, heartbeats and flight rings without
loading torch.
"""

import logging
import time
from pathlib import Path

from ..config.telemetry_config import TelemetryConfig
from . import tracectx
from .anomaly import Anomaly, AnomalyDetector
from .device_stats import (
    arm_beacons,
    attach_beacon_run_dir,
    beacons_armed,
    detach_beacon_run_dir,
    device_stats_record,
    drain_beacons,
)
from .flight import FLIGHT_FILENAME, DispatchWatchdog, FlightRecorder
from .health import HealthMonitor, Watchdog, device_memory_stats, dump_thread_stacks
from .ledger import METRICS_FILENAME, MetricsLedger, tick_record
from .perf import UtilizationMeter
from .tracer import SpanTracer

logger = logging.getLogger(__name__)

__all__ = [
    "Anomaly",
    "AnomalyDetector",
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
    """One run's telemetry: tracer, heartbeat and stall watchdog, anomaly
    screen, ledger and meter, flight recorder and dispatch watchdog.

    `start()` when the loop or the serving begins, `on_rollout` /
    `on_learner_step` as work lands (O(1), any thread), `on_util_tick` /
    `on_tick` once per iteration or tick (the only places with IO; the
    heartbeat that `on_tick` writes carries the card's memory as
    `on_util_tick` read it just before),
    `close()` at the end."""

    def __init__(
        self,
        config: TelemetryConfig | None = None,
        run_dir: Path | str = ".",
        stats=None,
        run_name: str = "",
        clock=time.monotonic,
        perf: UtilizationMeter | None = None,
    ) -> None:
        self.config = cfg = config or TelemetryConfig()
        self.run_dir = Path(run_dir)
        self.stats = stats
        self.run_name = run_name
        enabled = cfg.ENABLED
        self.tracer = SpanTracer()
        self.health = HealthMonitor(
            self.run_dir / HEALTH_FILENAME, deadline_s=cfg.WATCHDOG_DEADLINE_S, run_name=run_name,
            clock=clock,
        )
        self.anomaly = AnomalyDetector()
        self.perf = perf
        self.ledger = MetricsLedger(self.run_dir / METRICS_FILENAME) if enabled else None
        if perf is not None:
            self.health.set_device_info(perf.device_kind, perf.peak_tflops, perf.peak_source)
        # Components pick the recorder up as their `flight` attribute
        # (training/setup.py, serving/service.py).
        self.watchdog: Watchdog | None = None
        self.flight: FlightRecorder | None = None
        self.dispatch_watchdog: DispatchWatchdog | None = None
        if enabled:
            self.watchdog = Watchdog(
                self.health, deadline_s=cfg.WATCHDOG_DEADLINE_S, on_stall=self._on_stall, clock=clock
            )
            self.dispatch_watchdog = DispatchWatchdog(
                self.run_dir, poll_s=cfg.DISPATCH_WATCHDOG_POLL_S, on_wedge=self._on_wedge, clock=clock,
                on_warn=self._on_dispatch_warn,
            )
            # A spawning parent's trace context (the env seam) becomes the
            # ring's base trace, linking every dispatch here back to the
            # spawn event.
            parent_ctx = tracectx.from_env()
            self.flight = FlightRecorder(
                self.run_dir / FLIGHT_FILENAME,
                min_deadline_s=cfg.DISPATCH_MIN_DEADLINE_S,
                first_deadline_s=cfg.DISPATCH_FIRST_DEADLINE_S,
                watchdog=self.dispatch_watchdog,
                base_trace=parent_ctx.fields() if parent_ctx is not None else None,
            )
            # Beacon rows of this process go to this run's beacons.jsonl;
            # no file is made until an armed site writes one.
            attach_beacon_run_dir(self.run_dir)
        self._step = 0
        # The card's memory as the last utilization tick read it, for the
        # heartbeat written after it (one read a tick, not two).
        self._tick_memory: "list | None" = None
        self._last_write_mono = None
        self._last_written_step: int | None = None
        self._clock = clock
        self._closed = False
        # (program, key) of the build cache's records this run ledgered.
        self._memory_seen: set = set()
        self._cost_seen: set = set()

    @property
    def enabled(self) -> bool:
        return self.config.ENABLED

    def start(self) -> None:
        if self.watchdog is not None:
            self.watchdog.start()
        if self.dispatch_watchdog is not None:
            self.dispatch_watchdog.start()

    def close(self, step: int | None = None) -> None:
        """Stop the watchdogs; write the flight ring's overhead record,
        the card's last published beacon rows (then no more rows go to
        this run's file), the final heartbeat and the span trace."""
        if self._closed:
            return
        self._closed = True
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.dispatch_watchdog is not None:
            self.dispatch_watchdog.stop()
        if self.flight is not None:
            self.flight.close()
        if not self.enabled:
            return
        drain_beacons()
        detach_beacon_run_dir(self.run_dir)
        self._ledger_program_records()
        if step is not None:
            self._step = step
        self.health.write()
        n = self.tracer.export(self.run_dir / TRACE_FILENAME)
        logger.info(
            "Telemetry: %d span(s) -> %s, heartbeat -> %s",
            n, self.run_dir / TRACE_FILENAME, self.health.path,
        )

    def on_rollout(self, experiences: int = 0, episodes: int = 0) -> None:
        if self.enabled:
            self.health.note_rollout(experiences, episodes)

    def on_learner_step(self, step: int, metrics: dict) -> list[Anomaly]:
        """Record learner progress and screen this step's metrics, named
        as the stats pipeline names them (`Loss/total_loss`,
        `Loss/Grad_Norm`, `Loss/Entropy`, ...). Returns the anomalies,
        already escalated to `Anomaly/*` metrics and warnings."""
        self._step = step
        if not self.enabled:
            return []
        self.health.note_learner_step(step)
        values = {}
        for name, value in metrics.items():
            try:
                values[name] = float(value)
            except (TypeError, ValueError):
                continue
        anomalies = self.anomaly.observe_metrics(values, step)
        self._escalate(anomalies, step)
        return anomalies

    def _escalate(self, anomalies: list, step: int) -> None:
        for a in anomalies:
            logger.warning("Training anomaly: %s", a.describe())
            if self.stats is not None:
                self.stats.log_scalar(f"Anomaly/{a.kind}", 1.0, step)

    def record_metrics(self, step: int, means: dict) -> None:
        """Ledger one processed metric batch: the `StatsCollector`'s tick
        sink, so every flush lands, the final ones included."""
        if self.ledger is not None and means:
            self.ledger.append(tick_record(step, means))

    def record_device_stats(self, step: int, program: "str | None" = None, **legs) -> "dict | None":
        """Ledger one `kind: "device_stats"` record from the legs the host
        folded out of the iteration's fetch (search / rollout / per /
        learner / serve), and screen its search or serve leg for a value
        explosion, a root-entropy collapse or a saturated tree. Returns
        the record; None when disabled or every leg is empty."""
        if not self.enabled:
            return None
        record = device_stats_record(step, program=program, **legs)
        if record is None:
            return None
        if self.ledger is not None:
            self.ledger.append(record)
        search_leg = record.get("search") or record.get("serve")
        if search_leg:
            self._escalate(self.anomaly.observe_search(search_leg, step), step)
        return record

    def record_memory(self, record: "dict | None") -> None:
        """Ledger one static memory-attribution record (the learner
        state's or a replay ring's bytes, a measured program;
        telemetry/memory.py; `cli mem` renders them)."""
        if self.ledger is not None and record:
            self.ledger.append(record)

    def _ledger_program_records(self) -> None:
        """Append the program memory and cost records the process's build
        cache holds that this run has not ledgered yet (components
        register a cost record at a program's first dispatch, so this runs
        every util tick and at close; the seen-sets are this run's)."""
        if self.ledger is None:
            return
        from ..compile_cache import get_build_cache

        cache = get_build_cache()
        for records, seen in ((cache.memory_summary(), self._memory_seen),
                              (cache.cost_summary(), self._cost_seen)):
            for record in records:
                rid = (record.get("program"), record.get("key"))
                if rid not in seen:
                    seen.add(rid)
                    self.ledger.append(record)

    def on_util_tick(self, step: int, **counters) -> "dict | None":
        """Derive and ledger one utilization record from the caller's
        cumulative counters (`UtilizationMeter.tick`'s keys) and the
        build cache's hits and misses; the card's memory is read here and
        screened for monotonic growth. Returns the record."""
        if not self.enabled or self.perf is None:
            return None
        if "compile_hits" not in counters:
            from ..compile_cache import get_build_cache

            cc = get_build_cache().stats()
            counters["compile_hits"] = cc["hits"]
            counters["compile_misses"] = cc["misses"]
        self._ledger_program_records()
        if "device_memory" not in counters:
            counters["device_memory"] = device_memory_stats()
        self._tick_memory = counters["device_memory"]
        record = self.perf.tick(step, **counters)
        if record is None:
            return None
        if self.ledger is not None:
            self.ledger.append(record)
        self.health.note_utilization(record)
        in_use = record.get("mem_bytes_in_use")
        if isinstance(in_use, (int, float)):
            self._escalate(self.anomaly.observe_memory(in_use, step), step)
        return record

    def on_tick(self, step: int, buffer_size: int = 0) -> None:
        """Write the heartbeat when the step moved or the interval passed."""
        if not self.enabled:
            return
        self._step = step
        self.health.note_buffer(buffer_size)
        now = self._clock()
        due = (
            self._last_write_mono is None
            or step != self._last_written_step
            or now - self._last_write_mono >= self.config.HEALTH_WRITE_INTERVAL_S
        )
        memory, self._tick_memory = self._tick_memory, None
        if due:
            self._last_write_mono = now
            self._last_written_step = step
            self.health.write(memory)

    def _on_stall(self, age_s: float) -> None:
        """Stall watchdog hook: stacks, an instant span, the trace and
        the heartbeat on disk."""
        dump_thread_stacks(self.run_dir / STACKS_FILENAME)
        self.tracer.instant("watchdog_stall", age_s=round(age_s, 1))
        if self.stats is not None:
            self.stats.log_scalar("Health/stall", age_s, self._step)
        self.tracer.export(self.run_dir / TRACE_FILENAME)
        self.health.write()
        logger.warning(
            "Watchdog: thread stacks -> %s, span trace -> %s",
            self.run_dir / STACKS_FILENAME, self.run_dir / TRACE_FILENAME,
        )

    def _on_dispatch_warn(self, info: dict) -> None:
        """Near-deadline hook: a dispatch is running long, so arm the
        progress beacons now; the work enqueued after this reports its
        phases, and a later wedge names the phase it hung in."""
        self.tracer.instant(
            "dispatch_warn", program=info.get("program"), elapsed_s=info.get("elapsed_s")
        )
        if not beacons_armed():
            arm_beacons()

    def _on_wedge(self, info: dict) -> None:
        """Dispatch watchdog hook, before wedge_report.json and the exit:
        the trace into the wedge goes to disk. No heartbeat write: it
        reads the card's memory, and a wedged card could hang it."""
        self.tracer.instant(
            "dispatch_wedge", program=info.get("program"), elapsed_s=info.get("elapsed_s")
        )
        self.tracer.export(self.run_dir / TRACE_FILENAME)
        self.health.set_stalled(True)
