"""Run-telemetry configuration: the fields of
`alphatriangle_tpu/config/telemetry_config.py` that a fleet replica sets,
under the same names, defaults and bounds.

Every other knob of the JAX config stays at its JAX default as the
default argument of the part it sets: the span ring's size
(`tracer.SpanTracer`), the stall deadline and poll (`health`), the
ledger's and flight ring's rotation (`ledger.MetricsLedger`,
`flight.FlightRecorder`) and the dispatch deadline factor. Tracing, the
heartbeat and its watchdog, the ledger and the flight recorder with its
dispatch watchdog are always on.
"""

from dataclasses import dataclass

from ._base import ConfigBase, check_range


@dataclass
class TelemetryConfig(ConfigBase):
    """Knobs of the telemetry subsystem."""

    # health.json is rewritten when the step advances, and at least this
    # often while the loop ticks.
    HEALTH_WRITE_INTERVAL_S: float = 5.0

    # A dispatch in flight past 10 x its expected wall (floored at MIN;
    # FIRST before the program has sealed once) is a wedge: the watchdog
    # writes wedge_report.json and exits 113.
    DISPATCH_MIN_DEADLINE_S: float = 60.0
    DISPATCH_FIRST_DEADLINE_S: float = 900.0
    DISPATCH_WATCHDOG_POLL_S: float = 5.0

    def __post_init__(self) -> None:
        for name in (
            "HEALTH_WRITE_INTERVAL_S",
            "DISPATCH_MIN_DEADLINE_S",
            "DISPATCH_FIRST_DEADLINE_S",
            "DISPATCH_WATCHDOG_POLL_S",
        ):
            check_range(name, getattr(self, name), gt=0)
