"""Self-healing supervision: fault injection, the recovery policy and the
postmortem `diagnose` the serve fleet classifies replica deaths with.
Stdlib only: the fleet parent imports it without torch."""

from .policy import QUARANTINE_OVERRIDES, Action, RecoveryPolicy
from .supervisor import diagnose

__all__ = ["Action", "QUARANTINE_OVERRIDES", "RecoveryPolicy", "diagnose"]
