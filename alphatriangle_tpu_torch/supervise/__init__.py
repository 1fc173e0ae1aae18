"""Self-healing supervision: fault injection, the recovery policy, the
run supervisor (`cli supervise`) and the postmortem `diagnose` that it
and the serve fleet classify deaths with. Stdlib only: the supervisor
and fleet parents import it without torch."""

from .policy import QUARANTINE_OVERRIDES, Action, RecoveryPolicy
from .supervisor import (
    OVERRIDES_ENV,
    SUPERVISOR_FILENAME,
    Supervisor,
    diagnose,
    latest_committed_step,
)

__all__ = [
    "Action",
    "OVERRIDES_ENV",
    "QUARANTINE_OVERRIDES",
    "RecoveryPolicy",
    "SUPERVISOR_FILENAME",
    "Supervisor",
    "diagnose",
    "latest_committed_step",
]
