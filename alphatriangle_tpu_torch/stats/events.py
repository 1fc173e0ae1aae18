"""Metric event type: counterpart of `alphatriangle_tpu/stats/events.py`
(a dataclass in place of the pydantic model, the same fields)."""

import time
from dataclasses import dataclass, field
from typing import Any


@dataclass
class RawMetricEvent:
    """One raw metric observation, aggregated by the collector."""

    name: str
    value: float
    global_step: int = 0
    timestamp: float = field(default_factory=time.time)
    context: dict[str, Any] = field(default_factory=dict)
