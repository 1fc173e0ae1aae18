"""The measured-fit autotuner: counterpart of `alphatriangle_tpu/autotune/`.

Searches the `(SELF_PLAY_BATCH_SIZE, BUFFER_CAPACITY, chunk T, fused K,
dp, geometry)` space with `telemetry/memory.estimate_fit` as the
feasibility oracle and the analytic throughput model (`utils/flops.py`
over the card's peak, calibrated from earlier runs) as the objective.
Where the JAX package's oracle compiles a candidate's programs and runs
nothing, the port's runs each of them once on the card and reads the
caching allocator's peak. `cli tune` drives it and writes a
`tuned_preset.json` that `cli train --preset`, `cli warm` and `cli fit`
read; a tuned run ledgers its `tune_outcome`, which `cli tune
--calibrate` folds into the next search."""

from .artifact import (
    TUNE_OUTCOME_KIND,
    build_tuned_preset,
    default_artifact_path,
    ledger_tune_outcome,
    write_tuned_preset,
)
from .model import (
    Calibration,
    calibration_from_summary,
    calibration_from_targets,
    default_moves_per_game,
    expected_simulations,
    merge_calibrations,
    predict_throughput,
)
from .search import (
    TuneResult,
    default_oracle,
    materialize_candidate,
    ring_bytes_for,
    run_search,
)
from .space import (
    STATUS_DOMINATED,
    STATUS_FIT,
    STATUS_GATE,
    STATUS_OVER,
    STATUS_RING,
    Candidate,
    SearchSpace,
    divisibility_gate,
    prune_dominated,
)

__all__ = [
    "Calibration",
    "Candidate",
    "STATUS_DOMINATED",
    "STATUS_FIT",
    "STATUS_GATE",
    "STATUS_OVER",
    "STATUS_RING",
    "SearchSpace",
    "TUNE_OUTCOME_KIND",
    "TuneResult",
    "build_tuned_preset",
    "calibration_from_summary",
    "calibration_from_targets",
    "default_artifact_path",
    "default_moves_per_game",
    "default_oracle",
    "divisibility_gate",
    "expected_simulations",
    "ledger_tune_outcome",
    "materialize_candidate",
    "merge_calibrations",
    "predict_throughput",
    "prune_dominated",
    "ring_bytes_for",
    "run_search",
    "write_tuned_preset",
]
