"""The pruned feasibility search: counterpart of
`alphatriangle_tpu/autotune/search.py`. It picks the feasible candidate
of highest predicted games an hour.

The costly step is the feasibility oracle. The JAX package's compiles a
candidate's programs and reads their memory analysis, running nothing.
The port's runs them: `telemetry/memory.estimate_fit` builds the
candidate's net, engine and rings on the device, runs each hot program
once and reads the caching allocator's peak, so an oracle call on the
card costs seconds of the card's time and launches the search kernels
(and, in megastep mode, `per_sample`). The search calls it as seldom as
the reference does, in the same order:

1. **Gates** (free): divisibility and geometry (autotune/space.py).
2. **Ring math** (free): `replay_ring_bytes` is shape arithmetic; a
   candidate whose ring alone exceeds the limit is over unseen.
3. **Monotone-in-B dominance**: within a group the search walks B
   descending; the first B that fits wins the group and every smaller B
   is dominated unseen.
4. **Memo**: candidates sharing an `oracle_key()` share one answer.

Group winners then rank by predicted games/h (autotune/model.py). The
oracle is injectable, so the pruning is testable without a device.
"""

import gc
import logging
import time
from dataclasses import dataclass, field

from .model import Calibration, predict_throughput
from .space import (
    STATUS_DOMINATED,
    STATUS_FIT,
    STATUS_GATE,
    STATUS_OVER,
    STATUS_RING,
    Candidate,
    SearchSpace,
    divisibility_gate,
)

logger = logging.getLogger(__name__)


@dataclass
class TuneResult:
    """One search's outcome: a row a candidate (its axes, status and
    prediction), the winner (None when nothing fits), its budget and
    records, and the search's accounts."""

    rows: list = field(default_factory=list)
    best: "Candidate | None" = None
    best_prediction: "dict | None" = None
    best_budget: "dict | None" = None
    best_records: list = field(default_factory=list)
    oracle_calls: int = 0
    evaluated: int = 0
    limit_bytes: "float | None" = None

    def feasible_rows(self) -> list:
        return [r for r in self.rows if r["status"] == STATUS_FIT]


def materialize_candidate(candidate, base_env, base_model, base_train, mode):
    """(env, model, train) configs of one candidate. Geometry "plan"
    keeps the plan's board; a named geometry swaps its board in and
    re-derives the model's feature width, as the presets do. The train
    config is rebuilt through its constructor, so every validator a run
    would meet gates the candidate here."""
    from ..config import TrainConfig, expected_other_features_dim, geometry_preset

    if candidate.geometry == "plan":
        env, model = base_env, base_model
    else:
        env = geometry_preset(candidate.geometry)
        model = base_model.model_copy(
            update={"OTHER_NN_INPUT_FEATURES_DIM": expected_other_features_dim(env)}
        )
    model = model.model_copy(update={"INFERENCE_PRECISION": candidate.inference_precision})
    kw = base_train.model_dump()
    kw.update(
        SELF_PLAY_BATCH_SIZE=candidate.sp_batch,
        BUFFER_CAPACITY=candidate.capacity,
        ROLLOUT_CHUNK_MOVES=candidate.chunk,
        FUSED_LEARNER_STEPS=candidate.fused_k,
        PER_SAMPLE_BACKEND=candidate.per_sample,
        MIN_BUFFER_SIZE_TO_TRAIN=min(base_train.MIN_BUFFER_SIZE_TO_TRAIN, candidate.capacity),
    )
    if mode == "megastep":
        kw.update(FUSED_MEGASTEP=True, DEVICE_REPLAY="on", ASYNC_ROLLOUTS=False)
    return env, model, TrainConfig(**kw)


def candidate_mcts(base_mcts, candidate):
    """The search config a candidate's programs run with: the base one
    carrying the candidate's kernel axes."""
    return base_mcts.model_copy(update={
        "descent_gather": candidate.descent_gather,
        "backup_update": candidate.backup_update,
        "tree_reuse": candidate.tree_reuse,
    })


def ring_bytes_for(candidate, env, model) -> int:
    """Per-device replay-ring bytes of a candidate (shape arithmetic)."""
    from ..config import expected_other_features_dim
    from ..telemetry.memory import replay_ring_bytes

    shards = max(1, candidate.dp)
    return replay_ring_bytes(
        candidate.capacity,
        (model.GRID_INPUT_CHANNELS, env.ROWS, env.COLS),
        expected_other_features_dim(env),
        env.action_dim,
        shards=shards,
    ) // shards


def release_device(device) -> "int | None":
    """Free what the last oracle call left: collect the cycles its
    components' closures form, return the allocator's cached blocks and
    cuBLAS's workspaces. Returns `memory_allocated` after it (None off
    CUDA)."""
    import torch

    gc.collect()
    device = torch.device(device)
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(device)


def default_oracle(mcts_config, mode, device_replay=None, progress=None, device=None):
    """The feasibility oracle: `estimate_fit` over a candidate's hot
    programs (the rollout chunk and the fused learner group, and the
    megastep in megastep mode) on `device` (default CUDA). Returns a
    callable (candidate, env, model, train, limit) -> (fits, budget,
    records). `device_replay` defaults to True in megastep mode, which
    needs the device ring.

    Each call builds the candidate's components, runs its programs and
    then drops them (`release_device`), so the next candidate is
    measured on a card as empty as before it. A call that runs out of
    memory is a verdict: it does not fit, its budget holds what was
    measured before the failure and names the program and the error
    under "oom". Any other error propagates. The callable's `calls`
    lists, a call each, its seconds, budget, out-of-memory error and
    `memory_allocated` before and after it."""
    from ..device import resolve_device

    device = resolve_device(device)
    ring_on_device = (mode == "megastep") if device_replay is None else bool(device_replay)
    megastep = mode == "megastep"

    def oracle(candidate, env, model, train, limit):
        from ..bench_config import BenchPlan
        from ..telemetry.memory import FIT_OK, estimate_fit, fit_verdict

        programs = {"self_play_chunk", "learner_fused"}
        if megastep:
            programs.add("megastep")
        mcts = candidate_mcts(mcts_config, candidate)
        plan = BenchPlan(
            env=env, model=model, mcts=mcts, train=train, scale=f"tune/{candidate.label()}",
            sims=mcts.max_simulations, sp_batch=candidate.sp_batch, chunk=candidate.chunk,
            lbatch=train.BATCH_SIZE, fused_k=candidate.fused_k, device_replay=ring_on_device,
            serve_batch=candidate.sp_batch,
        )
        before = release_device(device)
        t0 = time.perf_counter()
        report = estimate_fit(plan, device, programs=programs, megastep=megastep, progress=progress)
        seconds = time.perf_counter() - t0
        after = release_device(device)
        budget = dict(report["budget"])
        if report["oom"] is not None:
            budget["oom"] = report["oom"]
            fits = False
        else:
            fits = fit_verdict(budget["total_bytes"], limit)[0] == FIT_OK
        oracle.calls.append({
            "candidate": candidate.label(), "seconds": seconds, "fits": fits,
            "budget_total_bytes": budget["total_bytes"], "oom": report["oom"],
            "allocated_before": before, "allocated_after": after, "device": str(device),
        })
        return fits, budget, report["records"]

    oracle.calls = []
    return oracle


def run_search(
    space: SearchSpace,
    base_env,
    base_model,
    base_mcts,
    base_train,
    limit_bytes: "float | None",
    calibration: "Calibration | None" = None,
    peak_tflops: "float | None" = None,
    mode: str = "sync",
    device_replay=None,
    oracle=None,
    progress=None,
    device=None,
) -> TuneResult:
    """Search the space for the feasible candidate of highest predicted
    games/h. `oracle` defaults to `default_oracle` on `device`; tests
    pass one of their own. With `limit_bytes` None the oracle's verdicts
    are all "unknown", so callers resolve a limit first."""
    cal = calibration or Calibration()
    if oracle is None:
        oracle = default_oracle(base_mcts, mode, device_replay=device_replay, progress=progress,
                                device=device)

    def say(msg: str) -> None:
        logger.info(msg)
        if progress is not None:
            progress(msg)

    result = TuneResult(limit_bytes=limit_bytes)
    lbatch = base_train.BATCH_SIZE
    min_buffer = base_train.MIN_BUFFER_SIZE_TO_TRAIN
    rows_by_candidate: dict = {}

    def add_row(candidate, status, prediction=None, detail="", budget=None):
        rows_by_candidate[candidate] = {
            "geometry": candidate.geometry,
            "sp_batch": candidate.sp_batch,
            "capacity": candidate.capacity,
            "chunk": candidate.chunk,
            "fused_k": candidate.fused_k,
            "dp": candidate.dp,
            "kernels": candidate.kernels(),
            "status": status,
            "detail": detail,
            "predicted": prediction,
            "budget_total_bytes": budget.get("total_bytes") if budget else None,
        }

    # Group the candidates (B descending within each) and predict every
    # ungated one up front: predictions are microseconds.
    groups: dict = {}
    for cand in space.candidates():
        groups.setdefault(cand.group_key(), []).append(cand)

    group_frontiers = []
    for key, members in groups.items():
        frontier = []
        for cand in members:
            gate_reason = divisibility_gate(cand, lbatch, min_buffer)
            if gate_reason is not None:
                add_row(cand, STATUS_GATE, detail=gate_reason)
                continue
            env, model, train = materialize_candidate(cand, base_env, base_model, base_train, mode)
            prediction = predict_throughput(
                cand, env, model, base_mcts, lbatch, calibration=cal, peak_tflops=peak_tflops,
                megastep=(mode == "megastep"),
            )
            ring = ring_bytes_for(cand, env, model)
            if limit_bytes is not None and ring > limit_bytes:
                add_row(cand, STATUS_RING, prediction=prediction,
                        detail=f"ring alone {ring} B > limit {int(limit_bytes)} B")
                continue
            frontier.append((cand, env, model, train, prediction))
        if frontier:
            group_frontiers.append((key, frontier))

    # Each group's frontier, B descending: the first B that fits wins the
    # group and the smaller ones are dominated.
    best = None
    oracle_memo: dict = {}
    for _key, frontier in group_frontiers:
        winner = None
        for cand, env, model, train, prediction in frontier:
            if winner is not None:
                add_row(cand, STATUS_DOMINATED, prediction=prediction,
                        detail=f"B{winner.sp_batch} fits in this group")
                continue
            memo_key = cand.oracle_key()
            cached = oracle_memo.get(memo_key)
            if cached is None:
                result.oracle_calls += 1
                say(f"tune: oracle {cand.label()} ...")
                t0 = time.perf_counter()
                cached = oracle(cand, env, model, train, limit_bytes)
                oracle_memo[memo_key] = cached
                say(f"tune: oracle {cand.label()}: {'fits' if cached[0] else 'over'}, budget "
                    f"{(cached[1] or {}).get('total_bytes')} B in {time.perf_counter() - t0:.1f}s")
            fits, budget, records = cached
            result.evaluated += 1
            if fits:
                winner = cand
                add_row(cand, STATUS_FIT, prediction=prediction, budget=budget)
                if best is None or prediction["games_per_hour"] > best[4]["games_per_hour"]:
                    best = (cand, env, model, train, prediction, budget, records)
            else:
                oom = (budget or {}).get("oom")
                add_row(cand, STATUS_OVER, prediction=prediction, budget=budget,
                        detail=f"out of memory in {oom}" if oom else "over budget")

    if best is not None:
        cand, _env, _model, _train, prediction, budget, records = best
        result.best = cand
        result.best_prediction = prediction
        result.best_budget = budget
        result.best_records = records
    result.rows = sorted(
        rows_by_candidate.values(),
        key=lambda r: (
            -(r["predicted"] or {}).get("games_per_hour", 0.0),
            r["geometry"],
            -r["sp_batch"],
        ),
    )
    return result
