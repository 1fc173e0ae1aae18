"""Run-telemetry configuration: the fields of
`alphatriangle_tpu/config/telemetry_config.py` that a training run and a
fleet replica set, under the same names, defaults and bounds.

Every other knob of the JAX config stays at its JAX default as the
default argument of the part it sets: the span ring's size
(`tracer.SpanTracer`), the stall watchdog's poll (`health.Watchdog`),
the anomaly screen's thresholds (`anomaly.AnomalyDetector`), the
dispatch deadline factor and the ledger's and flight ring's rotation
(`ledger.MetricsLedger`, `flight.FlightRecorder`). With `ENABLED`, the
heartbeat and its watchdog, the anomaly screen, the ledger, the flight
recorder with its dispatch watchdog and the device stat-packs
(`telemetry/device_stats.py`) are all on; progress beacons arm by
environment or by the dispatch watchdog's near-deadline warning. The
JAX config's `DEVICE_STATS`, `BEACON_EVERY_N_WAVES` and
`DISPATCH_WARN_FRACTION` stay at their defaults too: the stat-packs
follow `ENABLED` (`ALPHATRIANGLE_DEVICE_STATS` overrides it), the
beacons' wave rate is `ALPHATRIANGLE_BEACON_EVERY` (8) and the warning
fraction is `flight.DispatchWatchdog`'s (0.5). The Prometheus textfile
is not ported yet.
"""

from dataclasses import dataclass

from ._base import ConfigBase, check_range


@dataclass
class TelemetryConfig(ConfigBase):
    """Knobs of the telemetry subsystem."""

    # Off: every hook is a no-op and no file is written.
    ENABLED: bool = True

    # health.json is rewritten when the step advances, and at least this
    # often while the loop ticks.
    HEALTH_WRITE_INTERVAL_S: float = 5.0
    # No learner step and no rollout harvest for this long is a stall:
    # the watchdog dumps every thread's stack and flags the heartbeat.
    WATCHDOG_DEADLINE_S: float = 300.0

    # A dispatch in flight past 10 x its expected wall (floored at MIN;
    # FIRST before the program has sealed once) is a wedge: the watchdog
    # writes wedge_report.json and exits 113.
    DISPATCH_MIN_DEADLINE_S: float = 60.0
    DISPATCH_FIRST_DEADLINE_S: float = 900.0
    DISPATCH_WATCHDOG_POLL_S: float = 5.0

    def __post_init__(self) -> None:
        for name in (
            "HEALTH_WRITE_INTERVAL_S",
            "WATCHDOG_DEADLINE_S",
            "DISPATCH_MIN_DEADLINE_S",
            "DISPATCH_FIRST_DEADLINE_S",
            "DISPATCH_WATCHDOG_POLL_S",
        ):
            check_range(name, getattr(self, name), gt=0)
