"""Policy serving: session slots, the batched service and its load generator."""

from .loadgen import run_simulated_load
from .service import PolicyService
from .session import Session, SessionSlots

__all__ = ["PolicyService", "Session", "SessionSlots", "run_simulated_load"]
