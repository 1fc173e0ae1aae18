"""Roofline attribution of the port: counterpart of
`alphatriangle_tpu/telemetry/roofline.py`, with its cost records, its
roofline rows against the card's machine balance and its chip-idle gap
forensics over the flight ring.

- **Cost records, analytic.** Eager PyTorch has no
  `compiled.cost_analysis()`. So a program's `kind: "cost"` record is
  analytic (`origin: "analytic"`), registered in the process's build
  cache (`compile_cache.py`) by the component that dispatches it, the
  first time it dispatches that program at a shape, and drained into the
  run's ledger (`RunTelemetry`). Its FLOPs are `utils/flops.py`'s
  matmul and conv counts (1 MAC = 2 FLOPs):
  - a self-play chunk of T moves over B lanes: T x B x (S + 1) forwards,
    S the expected simulations a move (p x S_full + (1 - p) x S_fast
    under playout caps), one root evaluation besides;
  - a search (`serve/b<B>` dispatch): B x (S + 1) forwards;
  - a learner group of K steps on a batch of b rows: K x
    `train_step_flops(b)`;
  - a megastep: its chunk's and its learner group's.
  Its bytes are what the program must move between memory and the
  card's cores, each item once where it is used:
  - the weights once per network evaluation: a search of S
    simulations in waves of w members (w the largest divisor of S up
    to `mcts_batch_size`) evaluates S / w waves and its root, so
    (S / w + 1) x `params` a move (expected over full and fast moves
    under playout caps);
  - the carried state read and written once a program (2 x `state`:
    the rollout carry, the serve slots);
  - a learner group of K steps reads and writes the parameters and
    AdamW moments every step (K x 2 x (`params` + `moments`)) and reads
    each step's b rows (K x b x `row`);
  - each chunk's rows written once (T x B x `row`; a row is the grid,
    the features, the policy and value targets and the policy weight,
    float32).
  So chunk = T x (S / w + 1) x params + 2 x carry + T x B x row; serve
  = (S / w + 1) x params + 2 x slots; learner = K x (b x row + 2 x
  (params + moments)). The tree a search builds and reads, and a
  step's activations, are left out, so the bytes stay a floor and the
  intensity a ceiling.
- **Roofline model.** Arithmetic intensity (FLOPs / byte) against the
  card's machine balance (peak FLOP/s over peak memory bandwidth,
  `peak_hbm_gbps_info`) classifies each program compute- or memory-
  bound; joined with the flight ring's measured p50 walls it gives the
  achieved-to-roofline fraction (`roofline_rows`).
- **Gap forensics** (`attribute_gaps`): the sealed dispatch intervals'
  union against the idle gaps between them, each gap attributed to the
  host spans of the run's `trace.json` (the loop's profile phases,
  `profiling.ProfileSession`, and the telemetry's own spans).

The readers import no torch: `cli roofline` renders beside a wedged
card. The cost builders (`chunk_cost`, `learner_cost`, `megastep_cost`,
`serve_cost`) read the components they are given.
"""

import json
import logging
import os
import time
from pathlib import Path

logger = logging.getLogger(__name__)

COST_KIND = "cost"

# Operator-supplied peak memory bandwidth override (GB/s): lets CPU
# smokes and unlisted cards still produce a machine balance (parallel
# to utils/flops.py's ALPHATRIANGLE_PEAK_TFLOPS).
PEAK_HBM_GBPS_ENV = "ALPHATRIANGLE_PEAK_HBM_GBPS"

# Peak memory bandwidth per device, GB/s, by `torch.cuda.get_device_name`:
# NVIDIA's H100 datasheet (SXM5 80GB HBM3 3.35 TB/s, PCIe 2 TB/s, NVL
# 3.9 TB/s); the TPU chips' public figures, v4 1228, v5e (v5 lite) 819,
# v5p 2765, v6e (Trillium) 1638. No H100 key is a prefix of another.
_PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "NVIDIA H100 PCIe": 2000.0,
    "NVIDIA H100 NVL": 3900.0,
    "TPU v4": 1228.0,
    "TPU v5 lite": 819.0,
    "TPU v5e": 819.0,
    "TPU v5": 2765.0,
    "TPU v5p": 2765.0,
    "TPU v6 lite": 1638.0,
    "TPU v6e": 1638.0,
}

#: Named host-gap categories, attribution order. "other" absorbs every
#: idle second no span claims, so dispatch + gaps always cover the
#: whole flight timeline.
GAP_CATEGORIES = ("fetch", "ingest", "ledger", "checkpoint", "other")

# Span-name keywords -> gap category. The loop's host phases
# (`training/loop.py` profile phases): result fetch/harvest lands in
# "fetch", replay fold/sampling in "ingest", telemetry/stats ticks in
# "ledger", checkpoint + weight sync in "checkpoint".
_SPAN_CATEGORY_KEYWORDS = (
    ("fetch", ("fetch", "harvest", "rollout", "d2h")),
    ("ingest", ("fold", "sample", "ingest", "enqueue", "stream", "h2d")),
    ("ledger", ("ledger", "tick", "stats", "telemetry", "health", "prom")),
    ("checkpoint", ("checkpoint", "weight_sync", "save")),
)


def peak_hbm_gbps_info(device_kind: str) -> "tuple[float | None, str]":
    """(peak memory GB/s, source) for a device kind (a CUDA device's
    `torch.cuda.get_device_name`).

    Source is "env" (ALPHATRIANGLE_PEAK_HBM_GBPS override — wins so
    operators can assert a bandwidth for unlisted chips or CPU
    smokes), "table" (known chip), or "unknown" (peak None — an
    explicit marker, never a guessed denominator). Mirrors
    `utils.flops.peak_bf16_tflops_info` including the space-insensitive
    longest-prefix fallback over runtime device-kind variants.
    """
    override = os.environ.get(PEAK_HBM_GBPS_ENV, "").strip()
    if override:
        try:
            value = float(override)
            if value > 0:
                return value, "env"
            logger.warning(
                "%s=%r is not positive; ignoring.", PEAK_HBM_GBPS_ENV,
                override,
            )
        except ValueError:
            logger.warning(
                "%s=%r is not a number; ignoring.", PEAK_HBM_GBPS_ENV,
                override,
            )
    kind = (device_kind or "").strip()
    if kind in _PEAK_HBM_GBPS:
        return _PEAK_HBM_GBPS[kind], "table"
    norm = kind.lower().replace(" ", "")
    best = None
    for name, peak in _PEAK_HBM_GBPS.items():
        key = name.lower().replace(" ", "")
        if norm.startswith(key) and (best is None or len(key) > best[0]):
            best = (len(key), peak)
    if best:
        return best[1], "table"
    return None, "unknown"


def machine_balance_flops_per_byte(
    peak_tflops, peak_hbm_gbps
) -> "float | None":
    """Machine balance (FLOPs per byte): programs whose arithmetic
    intensity exceeds it are compute-bound on this chip, the rest are
    bandwidth-bound. None when either peak is unknown."""
    if not _num(peak_tflops) or not _num(peak_hbm_gbps):
        return None
    if peak_tflops <= 0 or peak_hbm_gbps <= 0:
        return None
    return (peak_tflops * 1e12) / (peak_hbm_gbps * 1e9)


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


# --- cost records (writer side; registered in the build cache) ----------


def program_cost_record(
    name: str,
    flops: "float | None",
    bytes_accessed: "float | None",
    transcendentals: "float | None" = None,
    backend: str = "",
    key: str = "",
    origin: str = "analytic",
    formula: "str | None" = None,
) -> dict:
    """One `kind: "cost"` record, the JAX record's fields, from the
    analytic FLOPs and bytes of one dispatch of `name` (module doc);
    `formula`, where given, is the arithmetic that made them."""
    record = {
        "kind": COST_KIND,
        "category": "program",
        "component": f"program/{name}",
        "program": name,
        "key": key,
        "backend": backend,
        "origin": origin,
        "flops": float(flops) if _num(flops) else None,
        "bytes_accessed": float(bytes_accessed) if _num(bytes_accessed) else None,
        "transcendentals": float(transcendentals) if _num(transcendentals) else None,
        "time": time.time(),
    }
    if formula is not None:
        record["formula"] = formula
    return record


def note_program_cost(name: str, cost, key: str = "", backend: str = "") -> None:
    """Register `name`'s analytic record at `key` in the process's build
    cache, once: `cost()` gives its (flops, bytes) the first time (the
    dispatch sites call this at every dispatch) and the formula beside
    them."""
    from ..compile_cache import get_build_cache

    cache = get_build_cache()
    if cache.enabled and cache.cost_record_for(name, key) is None:
        flops, nbytes, formula = cost()
        cache.capture_cost(program_cost_record(name, flops, nbytes, backend=backend, key=key,
                                               formula=formula))


def _param_bytes(module) -> int:
    from .memory import tree_bytes

    return tree_bytes(list(module.parameters()))


def _row_bytes(engine) -> int:
    """One experience row's bytes, float32: grid, features, policy
    target, value target and policy weight."""
    c, h, w = engine._grid_shape
    return 4 * (c * h * w + engine._other_dim + engine._action_dim + 2)


def _forward(extractor, env) -> int:
    from ..utils.flops import forward_flops

    return forward_flops(extractor.model_config, env.cfg, env.action_dim)


def _expected(mcts_config, per_search) -> float:
    """`per_search(sims)` of a move: of the full count, or under playout
    caps p x that of the full + (1 - p) x that of the fast count."""
    value = float(per_search(mcts_config.max_simulations))
    if mcts_config.fast_simulations is not None:
        p = float(mcts_config.full_search_prob)
        value = p * value + (1.0 - p) * float(per_search(mcts_config.fast_simulations))
    return value


def _move_sims(mcts_config) -> float:
    """Expected simulations a move."""
    return _expected(mcts_config, lambda sims: sims)


def _move_evaluations(mcts_config) -> float:
    """Expected network evaluations a move: the search's waves (its
    simulations over the wave size, the largest divisor of them up to
    `mcts_batch_size`, as `mcts/search.py` tiles them) and the root's."""

    def waves(sims: int) -> int:
        w = max(1, min(mcts_config.mcts_batch_size, sims))
        while sims % w:
            w -= 1
        return sims // w

    return _expected(mcts_config, waves) + 1.0


def chunk_cost(engine, t: int) -> tuple:
    """(FLOPs, bytes, formula) of a self-play chunk of `t` moves: the
    weights once per evaluation, the carry read and written, the rows
    written."""
    from .memory import tree_bytes

    b, cfg = engine.batch_size, engine.mcts_config
    sims, evals, fwd = _move_sims(cfg), _move_evaluations(cfg), _forward(engine.extractor, engine.env)
    params, carry, row = _param_bytes(engine.net.model), tree_bytes(engine._carry), _row_bytes(engine)
    flops = t * b * (sims + 1.0) * fwd
    nbytes = t * evals * params + 2 * carry + t * b * row
    formula = (f"flops = T*B*(S+1)*fwd = {t}*{b}*({sims:g}+1)*{fwd}; "
               f"bytes = T*E*params + 2*carry + T*B*row = {t}*{evals:g}*{params} + 2*{carry} + {t}*{b}*{row}")
    return flops, nbytes, formula


def learner_cost(trainer, k: int, batch: int, row_bytes: int) -> tuple:
    """(FLOPs, bytes, formula) of a learner group of `k` steps on
    `batch` rows: each step reads its rows and reads and writes the
    parameters and moments."""
    from ..utils.flops import train_step_flops
    from .memory import tree_bytes

    mc = trainer.nn.model_config
    env = trainer.nn.env_config
    step = train_step_flops(mc, env, env.action_dim, batch)
    opt = trainer.state.opt_state
    state = _param_bytes(trainer.model) + tree_bytes([opt.mu, opt.nu])
    formula = (f"flops = K*step(b) = {k}*{step}; "
               f"bytes = K*(b*row + 2*(params+moments)) = {k}*({batch}*{row_bytes} + 2*{state})")
    return k * step, k * (batch * row_bytes + 2 * state), formula


def megastep_cost(runner, t: int, k: int, batch: int) -> tuple:
    """(FLOPs, bytes, formula) of a megastep: its chunk and its learner
    group."""
    cf, cb, chunk = chunk_cost(runner.engine, t)
    lf, lb, learner = learner_cost(runner.trainer, k, batch, _row_bytes(runner.engine))
    return cf + lf, cb + lb, f"chunk: {chunk}; learner: {learner}"


def serve_cost(service, slots: int) -> tuple:
    """(FLOPs, bytes, formula) of a serve dispatch (one search) at
    `slots` lanes: the weights once per evaluation, the slot array's
    states read and written."""
    from .memory import tree_bytes

    cfg = service.mcts.config
    sims, evals, fwd = _move_sims(cfg), _move_evaluations(cfg), _forward(service.extractor, service.env)
    params, states = _param_bytes(service.net.model), tree_bytes(service.sessions.states)
    formula = (f"flops = B*(S+1)*fwd = {slots}*({sims:g}+1)*{fwd}; "
               f"bytes = E*params + 2*slots = {evals:g}*{params} + 2*{states}")
    return slots * (sims + 1.0) * fwd, evals * params + 2 * states, formula


# --- readers (no torch on this path) -------------------------------------


def latest_cost_by_program(records) -> dict:
    """Newest usable cost record per program name (re-compiles re-emit;
    the roofline wants the latest of each). Non-dict and non-cost rows
    are skipped — torn/legacy ledgers degrade, never raise."""
    out: dict = {}
    for rec in records:
        if (
            isinstance(rec, dict)
            and rec.get("kind") == COST_KIND
            and rec.get("program")
        ):
            out[str(rec["program"])] = rec
    return out


def cost_flops_by_family(records) -> dict:
    """Per-family FLOPs per dispatch from the cost records: the hottest
    (max-FLOP) program of each family wins (the JAX autotuner's
    `cost_flops` calibration source)."""
    from .flight import program_family

    out: dict = {}
    for program, rec in latest_cost_by_program(records).items():
        flops = rec.get("flops")
        if not _num(flops) or flops <= 0:
            continue
        fam = program_family(program)
        if fam not in out or flops > out[fam]:
            out[fam] = float(flops)
    return out


def roofline_rows(
    cost_records,
    flight_rows,
    peak_tflops=None,
    peak_hbm_gbps=None,
) -> list:
    """Per-program roofline rows: `summarize_flight` rows joined with
    the newest cost record per program. Every flight row yields a row;
    programs with no cost record (legacy runs, torn sidecars) come out
    with None cost fields — "n/a" in the tables, never an error.

    Row fields: program, family, count, wall_s_p50, wall_s_total,
    flops, bytes_accessed, intensity (FLOPs/byte), bound ("compute" /
    "memory" / None), achieved_tflops (compiler FLOPs over measured
    p50 wall), roofline_tflops (the ceiling at this intensity), and
    roofline_fraction (achieved / ceiling).
    """
    balance = machine_balance_flops_per_byte(peak_tflops, peak_hbm_gbps)
    by_program = latest_cost_by_program(cost_records)
    rows = []
    for fr in flight_rows or []:
        if not isinstance(fr, dict):
            continue
        program = str(fr.get("program"))
        cost = by_program.get(program)
        flops = cost.get("flops") if cost else None
        bytes_accessed = cost.get("bytes_accessed") if cost else None
        intensity = None
        if _num(flops) and _num(bytes_accessed) and bytes_accessed > 0:
            intensity = flops / bytes_accessed
        bound = None
        if intensity is not None and balance is not None:
            bound = "compute" if intensity > balance else "memory"
        wall_p50 = fr.get("wall_s_p50")
        achieved = None
        if _num(flops) and _num(wall_p50) and wall_p50 > 0:
            achieved = flops / wall_p50
        ceiling = None
        if _num(peak_tflops) and peak_tflops > 0:
            ceiling = peak_tflops * 1e12
            if intensity is not None and _num(peak_hbm_gbps):
                ceiling = min(ceiling, intensity * peak_hbm_gbps * 1e9)
        fraction = None
        if achieved is not None and ceiling is not None and ceiling > 0:
            fraction = achieved / ceiling
        rows.append(
            {
                "program": program,
                "family": fr.get("family"),
                "count": fr.get("count"),
                "wall_s_p50": wall_p50,
                "wall_s_total": fr.get("wall_s_total"),
                "flops": flops if _num(flops) else None,
                "bytes_accessed": (
                    bytes_accessed if _num(bytes_accessed) else None
                ),
                "transcendentals": (
                    cost.get("transcendentals") if cost else None
                ),
                "intensity": (
                    round(intensity, 4) if intensity is not None else None
                ),
                "bound": bound,
                "achieved_tflops": (
                    round(achieved / 1e12, 6) if achieved is not None else None
                ),
                "roofline_tflops": (
                    round(ceiling / 1e12, 6) if ceiling is not None else None
                ),
                "roofline_fraction": (
                    round(fraction, 6) if fraction is not None else None
                ),
            }
        )
    return rows


# --- gap forensics -------------------------------------------------------


def load_trace_spans(trace_path) -> list:
    """(category, begin_s, end_s) wall-clock span intervals from a
    run's `trace.json` (telemetry/tracer.py: the loop's profile phases,
    `rollout`, `fold`, `sample`, `train`, `weight_sync`, `checkpoint`, and
    the telemetry's spans), keyword-mapped to gap categories;
    uncategorized spans are dropped (the residual lands in "other"
    anyway). A directory is read as a run's `profile_data/`: the
    `user_annotation` spans (the phases and `record_function` labels) of
    each `*.pt.trace.json` there, on its own clock (its
    `baseTimeNanoseconds` added where its times are relative to it).
    Missing or corrupt traces return []: gap attribution degrades to
    all-"other", never raises."""
    path = Path(trace_path)
    if path.is_dir():
        spans = [s for f in sorted(path.glob("*.pt.trace.json")) for s in _trace_spans(f, profiler=True)]
        return sorted(spans, key=lambda s: s[1])
    return _trace_spans(path)


def _trace_spans(path: Path, profiler: bool = False) -> list:
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        return []
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    if not isinstance(events, list):
        return []
    base_us = 0.0
    if profiler and isinstance(data, dict) and _num(data.get("baseTimeNanoseconds")):
        base_us = data["baseTimeNanoseconds"] / 1e3
    spans = []
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        if profiler and ev.get("cat") != "user_annotation":
            continue
        ts, dur = ev.get("ts"), ev.get("dur")
        if not _num(ts) or not _num(dur) or dur <= 0:
            continue
        category = _span_category(str(ev.get("name", "")))
        if category is None:
            continue
        if ts < base_us / 2:  # relative to the trace's base time
            ts += base_us
        begin = ts / 1e6  # Chrome traces use microseconds
        spans.append((category, begin, begin + dur / 1e6))
    spans.sort(key=lambda s: s[1])
    return spans


def _span_category(name: str) -> "str | None":
    low = name.lower()
    for category, keywords in _SPAN_CATEGORY_KEYWORDS:
        if any(k in low for k in keywords):
            return category
    return None


def _merge_intervals(intervals: list) -> list:
    """Sorted (begin, end) intervals -> merged disjoint intervals."""
    merged: list = []
    for begin, end in sorted(intervals):
        if end <= begin:
            continue
        if merged and begin <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([begin, end])
    return merged


def _overlap_seconds(merged: list, begin: float, end: float) -> float:
    """Seconds of a merged interval list that fall inside [begin, end]."""
    total = 0.0
    for b, e in merged:
        if e <= begin:
            continue
        if b >= end:
            break
        total += min(e, end) - max(b, begin)
    return total


def attribute_gaps(flight_records, spans=None) -> "dict | None":
    """Timeline attribution over a run's flight ring.

    Unions the sealed intent→seal intervals (t_mono) into chip-busy
    time; the complement within [first record, last record] is chip
    idle, attributed per gap to the named host categories via
    wall-clock span overlap (`spans` from `load_trace_spans`; the
    mono→wall offset is the median over the records that carry both
    stamps). Overclaimed gaps scale proportionally; unclaimed seconds
    land in "other" — dispatch + gaps therefore always cover the whole
    timeline (`attributed_fraction` 1.0 by construction, <1.0 only
    when intervals are unusable).

    Returns None when fewer than two timestamped records exist (a
    legacy or empty ring), else {wall_s, dispatch_s, gap_s, gaps:
    {category: s}, chip_idle_fraction, attributed_fraction,
    dispatches, unsealed}.
    """
    stamped = [
        r
        for r in flight_records or []
        if isinstance(r, dict) and _num(r.get("t_mono"))
    ]
    if len(stamped) < 2:
        return None
    t0 = min(r["t_mono"] for r in stamped)
    t1 = max(r["t_mono"] for r in stamped)
    wall = t1 - t0
    if wall <= 0:
        return None
    intents = {
        r.get("seq"): r for r in stamped if r.get("phase") == "intent"
    }
    dispatch_intervals = []
    dispatches = 0
    for r in stamped:
        if r.get("phase") != "seal":
            continue
        intent = intents.pop(r.get("seq"), None)
        if intent is None:
            continue
        dispatches += 1
        dispatch_intervals.append((intent["t_mono"], r["t_mono"]))
    busy = _merge_intervals(dispatch_intervals)
    dispatch_s = sum(e - b for b, e in busy)
    # Idle gaps: the complement of chip-busy within the timeline.
    gaps = []
    cursor = t0
    for b, e in busy:
        if b > cursor:
            gaps.append((cursor, b))
        cursor = max(cursor, e)
    if t1 > cursor:
        gaps.append((cursor, t1))
    # mono -> wall offset for span overlap (spans are wall-clock).
    offsets = sorted(
        r["time"] - r["t_mono"] for r in stamped if _num(r.get("time"))
    )
    offset = offsets[len(offsets) // 2] if offsets else None
    by_category = {}
    if spans and offset is not None:
        for category, begin, end in spans:
            by_category.setdefault(category, []).append((begin, end))
        by_category = {
            c: _merge_intervals(ivals) for c, ivals in by_category.items()
        }
    totals = {c: 0.0 for c in GAP_CATEGORIES}
    for begin, end in gaps:
        length = end - begin
        claimed = {}
        if by_category:
            wb, we = begin + offset, end + offset
            for category, merged in by_category.items():
                sec = _overlap_seconds(merged, wb, we)
                if sec > 0:
                    claimed[category] = sec
        claimed_total = sum(claimed.values())
        if claimed_total > length > 0:
            scale = length / claimed_total
            claimed = {c: s * scale for c, s in claimed.items()}
            claimed_total = length
        for category, sec in claimed.items():
            totals[category] += sec
        totals["other"] += max(0.0, length - claimed_total)
    gap_s = sum(e - b for b, e in gaps)
    return {
        "wall_s": round(wall, 6),
        "dispatch_s": round(dispatch_s, 6),
        "gap_s": round(gap_s, 6),
        "gaps": {c: round(s, 6) for c, s in totals.items()},
        "chip_idle_fraction": round(gap_s / wall, 6),
        "attributed_fraction": round((dispatch_s + gap_s) / wall, 6),
        "dispatches": dispatches,
        "unsealed": len(intents),
    }


# --- run-level summary (cli roofline / cli perf fold) --------------------


def summarize_roofline(
    cost_records,
    flight_records,
    device_kind: str = "",
    peak_tflops=None,
    trace_path=None,
) -> "dict | None":
    """The `cli roofline` payload: machine balance + per-program rows +
    gap attribution for one run. `peak_tflops` should come from the
    run's own util records (already env-resolved at run time); the
    bandwidth peak resolves here so `ALPHATRIANGLE_PEAK_HBM_GBPS` works
    at read time. `trace_path` is the run's `trace.json`, its
    `profile_data/` directory, or a list of both (`load_trace_spans`).
    None when the run has neither cost records nor a usable flight
    timeline (exit-2 territory for the CLI)."""
    from .flight import summarize_flight

    flight_rows = summarize_flight(flight_records or [])
    peak_gbps, hbm_source = peak_hbm_gbps_info(device_kind)
    rows = roofline_rows(
        cost_records or [],
        flight_rows,
        peak_tflops=peak_tflops,
        peak_hbm_gbps=peak_gbps,
    )
    paths = trace_path if isinstance(trace_path, (list, tuple)) else [trace_path] if trace_path else []
    spans = sorted((s for p in paths for s in load_trace_spans(p)), key=lambda s: s[1])
    attribution = attribute_gaps(flight_records or [], spans=spans)
    if not rows and attribution is None:
        return None
    balance = machine_balance_flops_per_byte(peak_tflops, peak_gbps)
    return {
        "schema": "alphatriangle.roofline.v1",
        "device_kind": device_kind,
        "peak_bf16_tflops": peak_tflops if _num(peak_tflops) else None,
        "peak_hbm_gbps": peak_gbps,
        "peak_hbm_source": hbm_source,
        "machine_balance_flops_per_byte": (
            round(balance, 4) if balance is not None else None
        ),
        "programs": rows,
        "attribution": attribution,
    }
