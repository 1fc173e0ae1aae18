"""Metric events and their collector; checkpoints, buffer spills and
restores of a training run."""

from .collector import StatsCollector
from .events import RawMetricEvent
from .persistence import CheckpointManager, LoadedTrainingState

__all__ = ["CheckpointManager", "LoadedTrainingState", "RawMetricEvent", "StatsCollector"]
