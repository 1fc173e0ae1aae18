"""Memory ledger of the port: counterpart of
`alphatriangle_tpu/telemetry/memory.py`, with its records, readers and
fit verdict.

- **Static attribution.** The learner's state (`train_state_record`:
  the trainer's parameters, its AdamW moments and the batch norms'
  running statistics) and the replay ring (`replay_ring_record`, from
  the bytes each ring allocated, which equal `replay_ring_bytes` of its
  geometry) are ledgered by training setup as `kind: "memory"` records.
- **Program records, measured.** Eager PyTorch has no
  `compiled.memory_analysis()`: a program is never compiled ahead of
  its run. So where the JAX package analyses a program without running
  it, the port runs it once at the plan's shapes in the process that
  asks (`cli fit`, `cli warm`, the `cli serve` pre-flight) and records
  the caching allocator's peak over that run above what was allocated
  before it (`measure_program`: `reset_peak_memory_stats`, the run,
  `max_memory_allocated`). Its `argument` bytes are the program's
  resident inputs by the same tensor-size accounting as the state's. A
  CUDA out-of-memory error in that run is the fit verdict "over"; it is
  not swallowed.
- **Budget composition** (`compose_budget`), `serve_budget_bytes`,
  `fit_verdict` and `attribution_rows` are the JAX package's, record
  for record, so the same records give the same budget and table.

The readers and the record builders import no torch: `cli mem`, `cli
perf` and `cli fit`'s verdict run beside a wedged card. `tree_bytes`
counts any object with `nbytes` (a tensor, an array); the torch parts
(`measure_program`, the card's limit in `resolve_bytes_limit`,
`sharded_megastep_dp`, `estimate_fit`) import it lazily.
"""

import dataclasses
import logging
import math
import time

logger = logging.getLogger(__name__)

MEMORY_KIND = "memory"

# Operator-supplied per-device byte budget override: lets `cli fit`
# assert a denominator where the card reports none (parallel to
# utils/flops.py's ALPHATRIANGLE_PEAK_TFLOPS).
BYTES_LIMIT_ENV = "ALPHATRIANGLE_DEVICE_BYTES_LIMIT"

# `cli fit` exit codes.
FIT_OK = 0  # budget fits the per-device limit
FIT_OVER = 1  # budget exceeds the limit, or a measured run ran out of memory
FIT_UNKNOWN = 2  # no device byte limit known (and no override)


def fmt_bytes(n) -> str:
    """Human bytes for tables: '1.50 GiB' / '320.0 KiB' / '—'."""
    if not isinstance(n, (int, float)) or isinstance(n, bool):
        return "—"
    n = float(n)
    for unit, scale in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if abs(n) >= scale:
            return f"{n / scale:,.2f} {unit}"
    return f"{n:,.0f} B"


# --- static attribution records -----------------------------------------


def tree_bytes(tree) -> int:
    """Total bytes of every tensor or array leaf of a tree (dicts, lists,
    tuples, dataclasses): each leaf's `nbytes`, its element count times
    its element size."""
    if tree is None:
        return 0
    nbytes = getattr(tree, "nbytes", None)
    if isinstance(nbytes, int) and not isinstance(tree, (bytes, bytearray)):
        return nbytes
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(tree_bytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    return 0


def program_memory_record(
    name: str,
    peak_bytes: int,
    argument_bytes: int = 0,
    backend: str = "",
    key: str = "",
    origin: str = "measured",
) -> dict:
    """One `kind: "memory"` program record from a measured run: the
    caching allocator's peak above the bytes allocated before the run
    (`peak_bytes`, the program's transient: its temporaries and new
    outputs) and its resident inputs (`argument_bytes`). The JAX
    record's fields, with the peak where XLA reports temp and output
    bytes (`temp` holds it; `output`, `generated_code` and `alias` are
    0: a run cannot split them)."""
    b = {
        "argument": int(argument_bytes),
        "output": 0,
        "temp": int(peak_bytes),
        "generated_code": 0,
        "alias": 0,
    }
    return {
        "kind": MEMORY_KIND,
        "category": "program",
        "component": f"program/{name}",
        "program": name,
        "key": key,
        "backend": backend,
        "origin": origin,
        "bytes": b,
        "total": b["argument"] + b["temp"],
        "transient": b["temp"],
        "peak": int(peak_bytes),
        "time": time.time(),
    }


def train_state_record(trainer) -> dict:
    """Tensor-size accounting of a `Trainer`'s state (the bytes training
    setup ledgers): its parameters, the optimizer's moments and the batch
    norms' running statistics. A tensor-parallel rank counts its shards."""
    opt = trainer.state.opt_state
    parts = {
        "params": tree_bytes(list(trainer.params)),
        "opt_state": tree_bytes([opt.mu, opt.nu]),
        "batch_stats": tree_bytes(trainer._stats_buffers()),
    }
    return {
        "kind": MEMORY_KIND,
        "category": "state",
        "component": "train_state",
        "bytes": parts,
        "total": sum(parts.values()),
        "time": time.time(),
    }


def replay_ring_bytes(
    capacity: int,
    grid_shape: tuple,
    other_dim: int,
    action_dim: int,
    shards: int = 1,
) -> int:
    """Exact bytes of a device replay ring's storage, from the shapes the
    rings allocate: one int8 grid cell per board cell, float32 everything
    else, one trash row per shard (rl/device_buffer.py,
    rl/sharded_device_buffer.py; tests hold it equal to the storage)."""
    rows = int(capacity) + int(shards)
    row_bytes = (
        int(math.prod(grid_shape))  # grid, int8
        + 4 * int(other_dim)  # other_features, float32
        + 4 * int(action_dim)  # policy_target, float32
        + 4  # value_target, float32
        + 4  # policy_weight, float32
    )
    return rows * row_bytes


def replay_ring_record(
    total_bytes: int,
    capacity: int,
    shards: int = 1,
    location: str = "device",
) -> dict:
    """The ledger record for one replay ring (location "device" for the
    card's rings, "host" for the host ring, which is listed in the table
    but left out of the card's budget)."""
    return {
        "kind": MEMORY_KIND,
        "category": "ring",
        "component": "replay_ring",
        "bytes": {"storage": int(total_bytes)},
        "total": int(total_bytes),
        "capacity": int(capacity),
        "shards": int(shards),
        "location": location,
        "time": time.time(),
    }


# --- live totals ---------------------------------------------------------


def summarize_device_memory(device_memory) -> "dict | None":
    """Fold `health.device_memory_stats()` rows into run totals:
    summed in-use/peak, summed limit (None when no device reports one)."""
    if not device_memory:
        return None
    in_use = 0
    peak = 0
    limits = []
    for d in device_memory:
        if not isinstance(d, dict):
            continue
        u = d.get("bytes_in_use")
        if isinstance(u, (int, float)):
            in_use += int(u)
        p = d.get("peak_bytes_in_use")
        peak += int(p) if isinstance(p, (int, float)) else (
            int(u) if isinstance(u, (int, float)) else 0
        )
        lim = d.get("bytes_limit")
        if isinstance(lim, (int, float)) and lim > 0:
            limits.append(int(lim))
    return {
        "bytes_in_use": in_use,
        "peak_bytes_in_use": peak,
        "bytes_limit": sum(limits) if limits else None,
    }


# --- budget composition --------------------------------------------------


def latest_by_component(records) -> dict:
    """Newest record per component name (re-runs re-emit records;
    attribution wants the latest of each)."""
    out: dict = {}
    for rec in records:
        if isinstance(rec, dict) and rec.get("component"):
            out[rec["component"]] = rec
    return out


def compose_budget(records) -> dict:
    """Fold memory records into the static per-device budget, as the JAX
    package does: train-state bytes + device replay ring (a dp-sharded
    ring's global bytes over its shards) + rollout residency (the
    self-play program's argument bytes less the parameters it shares
    with the train state) + the worst single program's transient (its
    `peak` when present). Host rings are left out."""
    latest = latest_by_component(records)
    state = next((r for r in latest.values() if r.get("category") == "state"), None)
    rings = [r for r in latest.values() if r.get("category") == "ring"]
    programs = [r for r in latest.values() if r.get("category") == "program"]
    params_bytes = int(((state or {}).get("bytes") or {}).get("params") or 0)
    state_total = int((state or {}).get("total") or 0)
    ring_device = sum(
        int(r.get("total") or 0) // max(1, int(r.get("shards") or 1))
        for r in rings
        if r.get("location") == "device"
    )
    rollout_resident = 0
    transient = 0
    for rec in programs:
        b = rec.get("bytes") or {}
        arg = int(b.get("argument") or 0)
        if str(rec.get("program") or "").startswith("self_play"):
            rollout_resident = max(rollout_resident, max(0, arg - params_bytes))
        peak = rec.get("peak")
        t = int(peak) if isinstance(peak, (int, float)) else int(rec.get("transient") or 0)
        transient = max(transient, t)
    return {
        "train_state_bytes": state_total,
        "replay_ring_bytes": ring_device,
        "rollout_resident_bytes": rollout_resident,
        "program_transient_bytes": transient,
        "total_bytes": state_total + ring_device + rollout_resident + transient,
        "programs": len(programs),
    }


def serve_budget_bytes(record) -> int:
    """Per-device bytes a standalone policy service needs, from its serve
    program's memory record: resident arguments (the net's weights and
    the slot array's states) plus the dispatch transient (its `peak`
    when present): the `cli serve` pre-flight's budget."""
    if not isinstance(record, dict):
        return 0
    b = record.get("bytes") or {}
    arg = int(b.get("argument") or 0)
    peak = record.get("peak")
    transient = int(peak) if isinstance(peak, (int, float)) else int(record.get("transient") or 0)
    return arg + transient


def fit_verdict(total_bytes, bytes_limit) -> tuple:
    """(exit code, reason) for a budget against a per-device limit."""
    if not isinstance(bytes_limit, (int, float)) or bytes_limit <= 0:
        return FIT_UNKNOWN, (
            "no device byte limit known for this backend (set "
            f"{BYTES_LIMIT_ENV} to assert one)"
        )
    frac = total_bytes / bytes_limit
    if total_bytes <= bytes_limit:
        return FIT_OK, (
            f"fits: {fmt_bytes(total_bytes)} is {frac:.1%} of the "
            f"{fmt_bytes(bytes_limit)} per-device limit"
        )
    return FIT_OVER, (
        f"OVER BUDGET: {fmt_bytes(total_bytes)} is {frac:.1%} of the "
        f"{fmt_bytes(bytes_limit)} per-device limit"
    )


# --- attribution rendering (no torch on this path) -----------------------


def attribution_rows(records) -> list:
    """(component, total bytes, detail) rows for `cli mem`'s table,
    biggest first."""
    rows = []
    for rec in latest_by_component(records).values():
        b = rec.get("bytes") or {}
        cat = rec.get("category")
        if cat == "program":
            detail = (
                f"args {fmt_bytes(b.get('argument'))}, "
                f"out {fmt_bytes(b.get('output'))}, "
                f"temp {fmt_bytes(b.get('temp'))}, "
                f"code {fmt_bytes(b.get('generated_code'))}"
            )
        elif cat == "state":
            detail = (
                f"params {fmt_bytes(b.get('params'))}, "
                f"opt {fmt_bytes(b.get('opt_state'))}, "
                f"bn {fmt_bytes(b.get('batch_stats'))}"
            )
        elif cat == "ring":
            detail = (
                f"capacity {rec.get('capacity'):,} x {rec.get('shards')} "
                f"shard(s), {rec.get('location')}"
            )
        else:
            detail = ""
        rows.append((rec.get("component") or "?", rec.get("total") or 0, detail))
    rows.sort(key=lambda r: -r[1])
    return rows


# --- limits and the measured pre-flight (torch, lazily) -------------------


def resolve_bytes_limit(limit_gb: "float | None", environ=None, device=None) -> tuple:
    """(per-device byte limit, source) in the `cli fit` order shared by
    fit and serve: an explicit --limit-gb wins, then the
    ALPHATRIANGLE_DEVICE_BYTES_LIMIT override, then the card's total
    memory (`torch.cuda.mem_get_info`; the smallest card's when `device`
    is None). (None, "none") when nothing is known: the CPU, or no card."""
    import os

    env = os.environ if environ is None else environ
    if limit_gb is not None:
        return limit_gb * 2**30, "flag"
    override = str(env.get(BYTES_LIMIT_ENV, "") or "").strip()
    if override:
        try:
            return float(override), "env"
        except ValueError:
            logger.warning("%s=%r is not a number; ignoring.", BYTES_LIMIT_ENV, override)
    try:
        import torch
    except ImportError:
        return None, "none"
    if device is not None and torch.device(device).type != "cuda":
        return None, "none"
    if not torch.cuda.is_available():
        return None, "none"
    cards = [torch.device(device).index or 0] if device is not None else range(torch.cuda.device_count())
    limits = [torch.cuda.mem_get_info(i)[1] for i in cards]
    return (min(limits), "device") if limits else (None, "none")


def sharded_megastep_dp(train_config) -> int:
    """The dp width the megastep of THIS process runs at: the process
    group's world when the geometry divides over it like the training
    setup's gate (`training/setup.py` `make_buffer`), else 1 (the
    single-device megastep). `cli fit` and `cli warm` run in one
    process, where it is 1."""
    from ..parallel.distributed import process_info

    _, world = process_info()
    if world > 1 and all(
        v % world == 0
        for v in (train_config.BUFFER_CAPACITY, train_config.BATCH_SIZE,
                  train_config.SELF_PLAY_BATCH_SIZE)
    ):
        return world
    return 1


def measure_program(name: str, fn, device, argument_bytes: int = 0, key: str = "") -> "dict | None":
    """Run `fn()` once on `device` and return its program record: the
    caching allocator's peak over the run above the bytes allocated
    before it. None off CUDA (the CPU has no allocator statistics). A
    CUDA out-of-memory error propagates: it is a verdict, not a gap."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        fn()
        return None
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    return program_memory_record(
        name, max(0, peak), argument_bytes=argument_bytes, backend="cuda", key=key
    )


def estimate_fit(plan, device, serve: bool = False, programs: "set[str] | None" = None,
                 progress=None, megastep: bool = True) -> dict:
    """Compose the memory budget of a plan's hot programs on `device`:
    the learner state and the ring (static records), then each program
    run once at the plan's shapes with its allocator peak measured
    (`measure_program`; the programs of `warm.plan_programs`, the serve
    rungs with `serve`, the megastep included, as the JAX `cli fit`
    analyses it). `programs` filters the labels by substring;
    `megastep=False` leaves the megastep, its trainer and its ring
    unbuilt (a synchronous loop's budget, `cli tune --mode sync`).

    Returns {"records", "budget", "oom"}: `oom` names the program whose
    run ran out of the card's memory and the error (the budget then
    holds what was measured before it), else None. On the CPU the
    programs run and record nothing: the budget is the static parts."""
    import torch

    from ..compile_cache import config_digest, get_build_cache, source_digest
    from ..warm import build_kernels, plan_programs

    def say(msg: str) -> None:
        logger.info(msg)
        if progress is not None:
            progress(msg)

    records: list = []
    oom = None
    label = "setup"
    try:
        build_kernels(device)
        static, targets = plan_programs(plan, device, serve=serve, megastep=megastep)
        records.extend(static)
        if programs:
            targets = [t for t in targets if any(p in t[0] for p in programs)]
        cache = get_build_cache()
        # A record is the code's and the configs' (the JAX key's digests).
        key = f"{source_digest()}-{config_digest(plan.env, plan.model, plan.mcts, plan.train)}"
        for label, run, arg_bytes in targets:
            t0 = time.perf_counter()
            rec = measure_program(label, run, device, argument_bytes=arg_bytes, key=key)
            if rec is None:
                say(f"fit: {label}: ran, no allocator statistics on {device}")
                continue
            records.append(cache.capture_memory(rec) or rec)
            say(f"fit: {label}: args {fmt_bytes(rec['bytes']['argument'])} peak {fmt_bytes(rec['peak'])}"
                f" ({time.perf_counter() - t0:.1f}s)")
    except torch.cuda.OutOfMemoryError as exc:
        oom = f"{label}: {type(exc).__name__}: {str(exc).splitlines()[0] if str(exc) else ''}"
        say(f"fit: out of memory ({oom})")
    return {"records": records, "budget": compose_budget(records), "oom": oom}
