"""Checkpoints, buffer spills and restores of a training run."""

from .persistence import CheckpointManager, LoadedTrainingState

__all__ = ["CheckpointManager", "LoadedTrainingState"]
