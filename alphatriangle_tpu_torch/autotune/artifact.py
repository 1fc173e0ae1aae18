"""The tuned-preset artifact and what a tuned run writes back:
counterpart of `alphatriangle_tpu/autotune/artifact.py`.

`cli tune` writes `runs/<run>/tuned_preset.json`
(`config.presets.TUNED_PRESET_SCHEMA`): the winner's config bundle, its
prediction, measured budget, calibration provenance and the search's
table. `config.presets.load_tuned_preset` reads it back for `cli train
--preset <path>`, `cli warm <path>` and `cli fit <path>`; the JAX
package's loader reads the port's artifact and the port's reads the JAX
package's.

After a completed `cli train --preset <tuned_preset.json>` run, the
tuner's prediction and the run's observed throughput go into one
`kind:"tune_outcome"` record of the run's metrics ledger, which the
next `cli tune --calibrate` reads (autotune/model.py). Stdlib only.
"""

import json
import logging
import time
from pathlib import Path

from ..config.presets import TUNED_PRESET_SCHEMA
from ..telemetry.ledger import read_ledger, resolve_ledger_path
from ..telemetry.perf import summarize_utilization

logger = logging.getLogger(__name__)

TUNE_OUTCOME_KIND = "tune_outcome"


def build_tuned_preset(
    result,
    env_config,
    model_config,
    mcts_config,
    train_config,
    scale: str,
    mode: str,
    backend: str,
    device_kind: str,
    limit_bytes,
    limit_source: str,
    calibration,
    run_name: str,
) -> dict:
    """The `tuned_preset.json` payload of a search with a winner. The
    configs are the WINNER's materialized configs; `backend` is the
    device type ("cuda" / "cpu"), `device_kind` the card's name."""
    cand = result.best
    if cand is None:
        raise ValueError("build_tuned_preset needs a feasible winner")
    return {
        "schema": TUNED_PRESET_SCHEMA,
        "created": time.time(),
        "run_name": run_name,
        "description": (
            f"autotuned {scale} ({mode}) on {backend}"
            f"{f'/{device_kind}' if device_kind else ''}: {cand.label()}"
        ),
        "scale": scale,
        "mode": mode,
        "backend": backend,
        "device_kind": device_kind,
        "candidate": {
            "geometry": cand.geometry,
            "sp_batch": cand.sp_batch,
            "capacity": cand.capacity,
            "chunk": cand.chunk,
            "fused_k": cand.fused_k,
            "dp": cand.dp,
        },
        # The kernel axes the winner was scored with; the config bundle
        # below carries the same values.
        "kernels": cand.kernels(),
        "configs": {
            "env": env_config.model_dump(),
            "model": model_config.model_dump(),
            "mcts": mcts_config.model_dump(),
            "train": train_config.model_dump(),
        },
        "predicted": result.best_prediction,
        "budget": result.best_budget,
        "limit_bytes": limit_bytes,
        "limit_source": limit_source,
        "calibration": calibration.as_dict() if calibration is not None else None,
        "search": {
            "rows": result.rows,
            "oracle_calls": result.oracle_calls,
            "evaluated": result.evaluated,
        },
    }


def write_tuned_preset(payload: dict, out_path) -> Path:
    """Write the artifact (parents created); returns its path."""
    path = Path(out_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2, default=str))
    return path


def default_artifact_path(run_name: str, root_dir=None) -> Path:
    """`runs/<run_name>/tuned_preset.json` under the runs root, resolved
    as `cli perf` / `cli mem` resolve a run name."""
    from ..config.persistence_config import PersistenceConfig

    persistence = PersistenceConfig(RUN_NAME=run_name)
    if root_dir:
        persistence = persistence.model_copy(update={"ROOT_DATA_DIR": str(root_dir)})
    return persistence.get_run_base_dir() / "tuned_preset.json"


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
