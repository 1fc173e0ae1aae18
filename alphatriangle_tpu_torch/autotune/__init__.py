"""The autotuner's run-side half: counterpart of
`alphatriangle_tpu/autotune/`, holding only what a tuned run writes
back (`artifact.ledger_tune_outcome`). The tuner itself (`cli tune`) is
not ported yet."""

from .artifact import TUNE_OUTCOME_KIND, ledger_tune_outcome

__all__ = ["TUNE_OUTCOME_KIND", "ledger_tune_outcome"]
