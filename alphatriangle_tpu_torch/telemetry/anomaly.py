"""Streaming training-anomaly detection over per-step metrics:
counterpart of `alphatriangle_tpu/telemetry/anomaly.py` (`Anomaly`,
`AnomalyDetector.observe`, `observe_memory`, `observe_search`,
`observe_metrics`), firing the same anomalies on the same series.

The detector keeps an EWMA mean and variance per metric (O(1) per
observation) and fires structured anomalies that `RunTelemetry`
escalates to `Anomaly/*` metrics and log warnings with the recent
window. Checks per observation:

- **nonfinite**: a NaN or inf value, never folded into the running
  statistics.
- **spike**: |value - ewma_mean| over `z_threshold` sigmas once the
  metric has `warmup` observations; the scale has a small absolute and
  relative floor, so a near-constant series does not fire on float
  jitter.
- **collapse**: an entropy metric at or below the floor after warm-up.
  Latched: one anomaly per excursion, re-armed when the metric recovers.
- **memory_growth** (`observe_memory`, fed per utilization tick with the
  card's bytes in use): a monotonic climb for `memory_growth_ticks`
  ticks that grew by at least `memory_growth_fraction`. Latched; any
  decrease re-arms it.
- **search health** (`observe_search`, fed one folded search or serve
  leg of the device stat-packs per record): `value_abs_max` through the
  nonfinite and spike checks as `Search/value_abs_max`; a root entropy
  at or below `search_entropy_floor` fires `collapse` on
  `Search/root_entropy`, an occupancy at or above `occupancy_ceiling`
  fires `saturation` on `Search/tree_occupancy`, each latched and
  re-armed by recovery. A partial leg skips the keys it lacks.

Stdlib only.
"""

import math
import threading
from collections import deque
from dataclasses import dataclass, field

EPS_ABS = 1e-8  # scale floors: keep z finite on constant series
EPS_REL = 1e-3


@dataclass
class Anomaly:
    """One detected anomaly, with recent-window context for the log."""

    kind: str  # "nonfinite" | "spike" | "collapse" | "memory_growth" | "saturation"
    metric: str
    step: int
    value: float
    zscore: float | None = None
    mean: float | None = None
    window: list = field(default_factory=list)  # recent (step, value)

    def describe(self) -> str:
        parts = [f"{self.kind} on {self.metric} at step {self.step}"]
        if self.kind == "spike" and self.zscore is not None:
            parts.append(
                f"value {self.value:.6g} is {self.zscore:.1f} sigma from ewma mean {self.mean:.6g}"
            )
        elif self.kind == "collapse":
            parts.append(f"value {self.value:.6g} at/below collapse floor")
        elif self.kind == "memory_growth":
            parts.append(
                f"bytes_in_use {self.value:,.0f} grew monotonically from {self.mean:,.0f} "
                "(possible leak)"
            )
        elif self.kind == "saturation":
            parts.append(
                f"value {self.value:.4g} at/above saturation ceiling — "
                "tree slots exhausted, extra simulations are wasted"
            )
        else:
            parts.append(f"value {self.value!r}")
        if self.window:
            recent = ", ".join(f"{v:.4g}" for _, v in self.window[-8:])
            parts.append(f"recent: [{recent}]")
        return "; ".join(parts)


class _MetricState:
    __slots__ = ("mean", "var", "n", "recent", "collapsed")

    def __init__(self, window: int) -> None:
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.recent: deque = deque(maxlen=window)
        self.collapsed = False


class AnomalyDetector:
    """Per-metric EWMA z-score and collapse checks, thread-safe."""

    def __init__(
        self,
        alpha: float = 0.02,
        z_threshold: float = 6.0,
        warmup: int = 20,
        window: int = 32,
        entropy_floor: float = 0.01,
        entropy_metrics: tuple[str, ...] = ("Loss/Entropy",),
        memory_growth_ticks: int = 12,
        memory_growth_fraction: float = 0.05,
        search_entropy_floor: float = 0.05,
        occupancy_ceiling: float = 0.98,
    ) -> None:
        self.alpha = alpha
        self.z_threshold = z_threshold
        self.warmup = warmup
        self.window = window
        self.entropy_floor = entropy_floor
        self.entropy_metrics = set(entropy_metrics)
        self.memory_growth_ticks = memory_growth_ticks
        self.memory_growth_fraction = memory_growth_fraction
        self.search_entropy_floor = search_entropy_floor
        self.occupancy_ceiling = occupancy_ceiling
        # observe_search's latches: one anomaly per excursion.
        self._search_collapsed = False
        self._search_saturated = False
        self._lock = threading.Lock()
        self._state: dict[str, _MetricState] = {}
        # Leak detector: the value at the start of the current monotonic
        # run, the run's length, and the latch.
        self._mem_prev: float | None = None
        self._mem_base: float | None = None
        self._mem_run = 0
        self._mem_fired = False
        self._mem_recent: deque = deque(maxlen=window)

    def observe(self, metric: str, value: float, step: int) -> list[Anomaly]:
        """Fold one observation; returns the anomalies it fired."""
        value = float(value)
        with self._lock:
            st = self._state.get(metric)
            if st is None:
                st = self._state[metric] = _MetricState(self.window)
            out: list[Anomaly] = []
            ctx = list(st.recent)
            if not math.isfinite(value):
                # Not folded: one NaN must not poison the baseline the
                # next finite values are judged against.
                return [Anomaly("nonfinite", metric, step, value, window=ctx)]
            if st.n >= self.warmup:
                scale = math.sqrt(max(st.var, 0.0)) + EPS_ABS + EPS_REL * abs(st.mean)
                z = abs(value - st.mean) / scale
                if z > self.z_threshold:
                    out.append(Anomaly("spike", metric, step, value, zscore=z, mean=st.mean, window=ctx))
            if metric in self.entropy_metrics and st.n >= self.warmup:
                if value <= self.entropy_floor:
                    if not st.collapsed:
                        st.collapsed = True
                        out.append(Anomaly("collapse", metric, step, value, mean=st.mean, window=ctx))
                else:
                    st.collapsed = False
            # EWMA update; during warm-up the weight decays as 1/(n+1), so
            # the early estimates are the plain sample mean and variance.
            a = max(self.alpha, 1.0 / (st.n + 1))
            d = value - st.mean
            st.mean += a * d
            st.var = (1.0 - a) * (st.var + a * d * d)
            st.n += 1
            st.recent.append((step, value))
            return out

    def observe_memory(self, bytes_in_use: float, step: int) -> list[Anomaly]:
        """Fold one tick's device bytes in use; fires `memory_growth` on a
        sustained monotonic climb, once per excursion."""
        value = float(bytes_in_use)
        with self._lock:
            out: list[Anomaly] = []
            if not math.isfinite(value):
                return out
            if self._mem_prev is None or value < self._mem_prev:
                # First sample, or memory released: a leak never shrinks.
                self._mem_base = value
                self._mem_run = 0
                self._mem_fired = False
            elif value > self._mem_prev:
                self._mem_run += 1
            self._mem_prev = value
            base = self._mem_base or 0.0
            grown = base > 0 and value >= base * (1.0 + self.memory_growth_fraction)
            if self._mem_run >= self.memory_growth_ticks and grown and not self._mem_fired:
                self._mem_fired = True
                out.append(
                    Anomaly(
                        "memory_growth", "Memory/bytes_in_use", step, value, mean=base,
                        window=list(self._mem_recent),
                    )
                )
            self._mem_recent.append((step, value))
            return out

    def observe_search(self, leg: dict, step: int) -> list[Anomaly]:
        """Screen one folded search leg of the device stat-packs; keys the
        leg lacks are skipped."""
        out: list[Anomaly] = []
        if not isinstance(leg, dict):
            return out
        v = leg.get("value_abs_max")
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            # A value explosion is a spike on this series.
            out.extend(self.observe("Search/value_abs_max", float(v), step))
        for key, metric, kind in (
            ("root_entropy", "Search/root_entropy", "collapse"),
            ("occupancy", "Search/tree_occupancy", "saturation"),
        ):
            x = leg.get(key)
            if not isinstance(x, (int, float)) or isinstance(x, bool) or not math.isfinite(float(x)):
                continue
            x = float(x)
            with self._lock:
                if kind == "collapse":
                    hit, latched = x <= self.search_entropy_floor, self._search_collapsed
                else:
                    hit, latched = x >= self.occupancy_ceiling, self._search_saturated
                if hit and not latched:
                    out.append(Anomaly(kind, metric, step, x))
                if kind == "collapse":
                    self._search_collapsed = hit
                else:
                    self._search_saturated = hit
        return out

    def observe_metrics(self, metrics: dict[str, float], step: int) -> list[Anomaly]:
        out: list[Anomaly] = []
        for name, value in metrics.items():
            out.extend(self.observe(name, value, step))
        return out
