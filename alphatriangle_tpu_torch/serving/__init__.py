"""Policy serving: session slots, the batched service with its bucket
ladder, and its load generator."""

from .buckets import BucketLadder, default_rungs
from .loadgen import run_simulated_load
from .service import PolicyService
from .session import Session, SessionSlots

__all__ = [
    "BucketLadder",
    "PolicyService",
    "Session",
    "SessionSlots",
    "default_rungs",
    "run_simulated_load",
]
