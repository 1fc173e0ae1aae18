"""Parity of the port's anomaly screen (`telemetry/anomaly.py`) and its
escalation through `RunTelemetry` with the JAX package's.

One seeded series per check goes through both detectors, which must
fire the same anomalies exactly (kind, metric, step, value; the
z-score and mean too, and the log line): a NaN and an inf that are not
folded, a spike after warm-up, an entropy collapse that re-arms when
the entropy recovers and fires again, a monotone memory climb next to
an allocator's sawtooth. Through `RunTelemetry.on_learner_step` /
`on_util_tick` the anomalies reach the stats as `Anomaly/<kind>` at
their step in both packages, and a disabled telemetry screens nothing.
"""

import math

import numpy as np
import pytest

from alphatriangle_tpu.config import TelemetryConfig as JaxTelemetryConfig
from alphatriangle_tpu.telemetry import RunTelemetry as JaxRunTelemetry
from alphatriangle_tpu.telemetry.anomaly import AnomalyDetector as JaxDetector
from alphatriangle_tpu.telemetry.perf import UtilizationMeter as JaxMeter
from alphatriangle_tpu_torch.config import TelemetryConfig
from alphatriangle_tpu_torch.telemetry import RunTelemetry
from alphatriangle_tpu_torch.telemetry.anomaly import AnomalyDetector
from alphatriangle_tpu_torch.telemetry.perf import UtilizationMeter
from torch_parity import plain_jax_programs  # noqa: F401 (autouse)


def _loss_series(seed: int) -> list:
    """(metric, value, step): two noisy losses and a grad norm with a NaN
    inside warm-up, an inf after it, and spikes after warm-up."""
    pick = np.random.default_rng(seed)
    out = []
    for step in range(1, 61):
        loss = 2.0 + 0.05 * pick.normal()
        grad = 10.0 + pick.normal()
        if step == 7:
            loss = float("nan")
        if step == 33:
            loss = 40.0  # a spike, long after warm-up
        if step == 45:
            grad = float("inf")
        if step == 50:
            grad = 200.0
        out += [("Loss/total_loss", loss, step), ("Loss/Grad_Norm", grad, step),
                ("Loss/value_loss", 1.0 + 0.01 * pick.normal(), step)]
    return out


def _entropy_series(seed: int) -> list:
    """Policy entropy that collapses, recovers, collapses again."""
    pick = np.random.default_rng(seed)
    out = []
    for step in range(1, 71):
        value = 1.5 + 0.1 * pick.normal()
        if 30 <= step < 36 or 55 <= step < 60:
            value = 0.004 * pick.random()  # at the floor: one anomaly per excursion
        out.append(("Loss/Entropy", value, step))
    return out


def _memory_series(seed: int, shape: str) -> list:
    """Bytes in use per tick: a monotone climb (a leak) or a sawtooth
    (a healthy allocator), with noise, then a release and a second climb."""
    pick = np.random.default_rng(seed)
    base, out = 4e9, []
    for tick in range(40):
        if shape == "climb":
            value = base * (1.0 + 0.01 * tick) if tick < 25 else base * (1.0 + 0.02 * (tick - 25))
        else:
            value = base * (1.0 + 0.03 * (tick % 5))
        out.append((float(int(value + pick.integers(0, 1024))), tick + 1))
    return out


def _key(a) -> tuple:
    value = a.value if math.isfinite(a.value) else repr(a.value)
    return (a.kind, a.metric, a.step, value, a.zscore, a.mean, [tuple(w) for w in a.window])


def _fired(detector, series) -> list:
    out = []
    for metric, value, step in series:
        out += detector.observe(metric, value, step)
    return out


@pytest.mark.parametrize("params", [{}, {"warmup": 5, "z_threshold": 4.0, "alpha": 0.1}])
@pytest.mark.parametrize("series", ["loss", "entropy"])
def test_observe_matches_jax(params, series):
    make = _loss_series if series == "loss" else _entropy_series
    data = make(3)
    ours, ref = _fired(AnomalyDetector(**params), data), _fired(JaxDetector(**params), data)
    assert [_key(a) for a in ours] == [_key(a) for a in ref]
    assert [a.describe() for a in ours] == [a.describe() for a in ref]
    kinds = {a.kind for a in ours}
    if series == "loss":
        assert {"nonfinite", "spike"} <= kinds
        assert {(a.kind, a.step) for a in ours} >= {("nonfinite", 7), ("nonfinite", 45), ("spike", 33)}
    else:
        # Latched: one collapse per excursion, re-armed by the recovery.
        assert [(a.kind, a.step) for a in ours if a.kind == "collapse"] == [("collapse", 30), ("collapse", 55)]


@pytest.mark.parametrize("shape", ["climb", "sawtooth"])
@pytest.mark.parametrize("ticks", [12, 5])
def test_observe_memory_matches_jax(shape, ticks):
    data = _memory_series(4, shape)
    kw = {"memory_growth_ticks": ticks, "memory_growth_fraction": 0.05}
    ours, ref = AnomalyDetector(**kw), JaxDetector(**kw)
    got = [a for value, tick in data for a in ours.observe_memory(value, tick)]
    want = [a for value, tick in data for a in ref.observe_memory(value, tick)]
    assert [_key(a) for a in got] == [_key(a) for a in want]
    assert [a.describe() for a in got] == [a.describe() for a in want]
    if shape == "sawtooth":
        assert got == []
    else:
        assert got and all(a.kind == "memory_growth" for a in got)


def test_observe_metrics_matches_jax():
    data = _loss_series(9)
    ours, ref = AnomalyDetector(warmup=4), JaxDetector(warmup=4)
    got, want = [], []
    for step in range(1, 61):
        batch = {m: v for m, v, s in data if s == step}
        got += ours.observe_metrics(batch, step)
        want += ref.observe_metrics(batch, step)
    assert [_key(a) for a in got] == [_key(a) for a in want] and got


class _Stats:
    def __init__(self):
        self.scalars = []

    def log_scalar(self, name, value, step=0):
        self.scalars.append((name, value, step))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


@pytest.mark.parametrize("enabled", [True, False])
def test_run_telemetry_escalates_as_jax(tmp_path, enabled):
    """The loop's hooks through both facades: `on_learner_step` screens a
    step's losses, gradient norm and entropy, `on_util_tick` the card's
    bytes in use; the same anomalies, the same `Anomaly/<kind>` scalars
    at the same steps. Nothing when disabled, and no file written."""
    ours_stats, ref_stats = _Stats(), _Stats()
    ours = RunTelemetry(
        TelemetryConfig(ENABLED=enabled), run_dir=tmp_path / "port", stats=ours_stats,
        perf=UtilizationMeter(forward_flops=1000, device_kind="cpu", clock=_Clock()),
    )
    ours.anomaly = AnomalyDetector(warmup=5, memory_growth_ticks=4)
    ref = JaxRunTelemetry(
        JaxTelemetryConfig(ENABLED=enabled, ANOMALY_WARMUP_STEPS=5, MEMORY_GROWTH_TICKS=4),
        run_dir=tmp_path / "jax", stats=ref_stats,
        perf=JaxMeter(forward_flops=1000, device_kind="cpu", clock=_Clock()),
    )
    got, want = [], []
    for step in range(1, 61):
        batch = {m: v for m, v, s in _loss_series(5) + _entropy_series(6) if s == step}
        got += ours.on_learner_step(step, batch)
        want += ref.on_learner_step(step, batch)
    assert [_key(a) for a in got] == [_key(a) for a in want]
    records = []
    for value, tick in _memory_series(7, "climb"):
        memory = [{"device": 0, "kind": "cpu", "bytes_in_use": value, "peak_bytes_in_use": value,
                   "bytes_limit": 80 << 30}]
        for tel in (ours, ref):
            records.append(tel.on_util_tick(
                60 + tick, experiences=tick, device_memory=memory, compile_hits=0, compile_misses=0
            ))
    assert ours_stats.scalars == ref_stats.scalars
    if enabled:
        assert {name for name, _, _ in ours_stats.scalars} >= {
            "Anomaly/nonfinite", "Anomaly/spike", "Anomaly/collapse", "Anomaly/memory_growth"
        }
        assert any(name == "Anomaly/memory_growth" for name, _, _ in ours_stats.scalars)
    else:
        assert got == [] and ours_stats.scalars == [] and records == [None] * len(records)
        ours.close(step=60)
        assert not (tmp_path / "port").exists()
