"""What a run of a tuned preset writes back: counterpart of
`alphatriangle_tpu/autotune/artifact.py`'s `ledger_tune_outcome` and
`TUNE_OUTCOME_KIND`.

After a completed `cli train --preset <tuned_preset.json>` run, the
tuner's prediction and the run's observed throughput go into one
`kind:"tune_outcome"` record of the run's metrics ledger, the record
the JAX `cli tune --calibrate` reads. Stdlib only.
"""

import json
import logging
import time
from pathlib import Path

from ..telemetry.ledger import read_ledger, resolve_ledger_path
from ..telemetry.perf import summarize_utilization

logger = logging.getLogger(__name__)

TUNE_OUTCOME_KIND = "tune_outcome"


def ledger_tune_outcome(run_dir, tuned_payload: dict) -> "dict | None":
    """Append predicted-vs-observed throughput to a completed run's
    metrics ledger: the run's util records summarized, beside the tuned
    preset's prediction. Returns the record, or None when the run has no
    ledger. A run too short for util records still gets a record, its
    observed fields null."""
    run_dir = Path(run_dir)
    ledger = resolve_ledger_path(run_dir)
    if ledger is None:
        logger.warning("tune: no metrics ledger under %s; outcome not recorded", run_dir)
        return None
    summary = summarize_utilization(read_ledger(ledger)) or {}
    predicted = tuned_payload.get("predicted") or {}
    record: dict = {
        "kind": TUNE_OUTCOME_KIND,
        "time": time.time(),
        "tuned_run_name": tuned_payload.get("run_name"),
        "schema": tuned_payload.get("schema"),
        "candidate": tuned_payload.get("candidate"),
        "predicted_games_per_hour": predicted.get("games_per_hour"),
        "predicted_moves_per_sec": predicted.get("moves_per_sec"),
        "observed_games_per_hour": summary.get("games_per_hour"),
        "observed_moves_per_sec": summary.get("moves_per_sec"),
        "observed_mfu": summary.get("mfu"),
    }
    pred = record["predicted_games_per_hour"]
    obs = record["observed_games_per_hour"]
    if isinstance(pred, (int, float)) and isinstance(obs, (int, float)) and pred > 0 and obs > 0:
        record["observed_over_predicted"] = obs / pred
    with ledger.open("a") as fh:
        fh.write(json.dumps(record) + "\n")
    logger.info(
        "tune: outcome ledgered to %s (predicted %.1f games/h, observed %s)",
        ledger,
        pred if isinstance(pred, (int, float)) else float("nan"),
        f"{obs:.1f}" if isinstance(obs, (int, float)) else "n/a",
    )
    return record
