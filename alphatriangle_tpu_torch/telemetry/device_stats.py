"""Device telemetry plane: stat-packs and progress beacons. Counterpart
of `alphatriangle_tpu/telemetry/device_stats.py`, with the same enable
state, environment variables, record formats, readers and folds.

**Stat-packs** (on with `TelemetryConfig.ENABLED`). Search-health figures
in the manner of KataGo (arXiv:1902.10565): the leaf-depth histogram,
root-visit entropy and concentration, the largest |value|, tree
occupancy and the share of root visits inherited through subtree reuse.
A search computes them from tensors already on the card and packs them
into one small float64 tensor (`SEARCH_PACK_SIZE` values: the
`DEPTH_BINS` histogram counts, accumulated in int64 and so exact, then
`SEARCH_SCALARS`); a rollout chunk stacks its moves' packs over T, and a
megastep adds a PER pack (`PER_SCALARS`). The packs ride the copy that
already ends the dispatch (`utils.transfer.fetch`): no new
synchronisation. The host unpacks them (`unpack_search_stats`), folds
them (`fold_search_stats`, `rollout_chunk_stats`, ...) and ledgers one
`kind:"device_stats"` record per iteration or serve tick
(`RunTelemetry.record_device_stats`), read back by `cli perf`.

**Progress beacons** (off by default). `emit_beacon(phase, index)` at
phase boundaries (every Nth search wave, each learner step, a
megastep's rollout and ring scatter) appends `(program, phase, index)`
rows to the run's `beacons.jsonl`. They arm by environment
(`ALPHATRIANGLE_BEACONS=1`) or by the dispatch watchdog's near-deadline
warning (`arm_beacons`); a wedge report then carries the last row
(`last_beacon`). On the card a beacon must name the phase the card has
reached, not the one the host last enqueued (the host enqueues a whole
dispatch before it blocks in the fetch), so `emit_beacon` launches the
beacon writer (`ops/beacon.py`, a hand-written CUDA kernel) on the
caller's stream: it writes the row's ids into a ring in mapped pinned
memory when the stream reaches it, and a host thread turns new slots
into rows. On the CPU the row is written at the call, which is program
order there. Subsampling is decided on the host (`index % every`), and
an unarmed site launches nothing and writes nothing. Eager PyTorch
builds no program, so arming takes effect at the next beacon site; the
dispatch already enqueued stays unarmed.

The module top imports neither torch nor numpy: `cli perf` and
`cli health` load the readers beside a wedged card.
"""

import json
import logging
import os
import threading
import time
from pathlib import Path

logger = logging.getLogger(__name__)

DEVICE_STATS_KIND = "device_stats"
BEACON_KIND = "beacon"
BEACONS_FILENAME = "beacons.jsonl"

#: Leaf-depth histogram bins of the search stat-pack. Depths at or past
#: the last bin clip into it, so the shape is static whatever max_depth.
DEPTH_BINS = 16

#: The scalars of a search stat-pack after its histogram, in pack order.
SEARCH_SCALARS = ("root_entropy", "root_concentration", "value_abs_max", "occupancy", "reuse_frac")
SEARCH_PACK_SIZE = DEPTH_BINS + len(SEARCH_SCALARS)
#: The scalars of a megastep's PER stat-pack, in pack order.
PER_SCALARS = ("priority_skew", "is_weight_min", "is_weight_max")

#: Default wave subsampling of search beacons: only every Nth wave
#: writes a row.
DEFAULT_BEACON_EVERY = 8

DEVICE_STATS_ENV = "ALPHATRIANGLE_DEVICE_STATS"
BEACONS_ENV = "ALPHATRIANGLE_BEACONS"
BEACON_EVERY_ENV = "ALPHATRIANGLE_BEACON_EVERY"

# --- process-wide enable state -------------------------------------------
# Engines read the stat-pack flag when they are built; training setup
# sets it from TelemetryConfig before any engine exists. The environment
# overrides let a smoke or a respawned child flip both without a config.

_lock = threading.Lock()
_device_stats: "bool | None" = None
_beacons_armed: "bool | None" = None
_beacon_every: "int | None" = None
_beacon_ledger = None  # telemetry.ledger.MetricsLedger once attached
_current_program: "str | None" = None


def device_stats_enabled() -> bool:
    """Whether engines built now compute stat-packs.

    Off until `set_device_stats` runs (training setup sets it from
    `TelemetryConfig.ENABLED`); `ALPHATRIANGLE_DEVICE_STATS=1/0`
    wins over both."""
    env = os.environ.get(DEVICE_STATS_ENV)
    if env is not None and env != "":
        return env != "0"
    return bool(_device_stats)


def set_device_stats(flag: bool) -> None:
    global _device_stats
    _device_stats = bool(flag)


def beacons_armed() -> bool:
    """Whether beacon sites reached from now on write rows."""
    global _beacons_armed
    if _beacons_armed is None:
        with _lock:
            if _beacons_armed is None:
                _beacons_armed = os.environ.get(BEACONS_ENV, "") not in ("", "0")
    return _beacons_armed


def arm_beacons(every: "int | None" = None) -> None:
    """Arm beacons for the sites reached after this call (the dispatch
    watchdog's near-deadline warning calls it). Work already enqueued
    on the card stays unarmed."""
    global _beacons_armed, _beacon_every
    with _lock:
        _beacons_armed = True
        if every is not None and every > 0:
            _beacon_every = int(every)
    logger.warning(
        "progress beacons ARMED (every %d search waves): phase rows go to %s",
        beacon_every(),
        BEACONS_FILENAME,
    )


def disarm_beacons() -> None:
    """Tests and teardown: forget the armed flag and the ledger; stop the
    card's beacon drainers after a last drain."""
    global _beacons_armed, _beacon_ledger
    _stop_rings()
    with _lock:
        _beacons_armed = False
        _beacon_ledger = None


def reset_device_stats_state() -> None:
    """Tests: back to the import-time defaults (the environment is read
    again at the next query)."""
    global _device_stats, _beacons_armed, _beacon_every, _beacon_ledger
    global _current_program
    _stop_rings()
    with _lock:
        _device_stats = None
        _beacons_armed = None
        _beacon_every = None
        _beacon_ledger = None
        _current_program = None


def beacon_every() -> int:
    global _beacon_every
    if _beacon_every is None:
        try:
            _beacon_every = max(1, int(os.environ.get(BEACON_EVERY_ENV, DEFAULT_BEACON_EVERY)))
        except ValueError:
            _beacon_every = DEFAULT_BEACON_EVERY
    return _beacon_every


def beacon_signature() -> str:
    """The JAX package's compile-cache key fragment for the beacon state
    (its armed programs embed host callbacks). The port builds no
    program; kept with JAX's strings for a compile cache to key on."""
    return f"|beacons{beacon_every()}" if beacons_armed() else ""


def device_stats_signature() -> str:
    """The JAX package's compile-cache key fragment for the stat-pack
    flag, kept with its strings like `beacon_signature`."""
    return "|devstats1" if device_stats_enabled() else ""


def attach_beacon_run_dir(run_dir) -> None:
    """Point beacon rows at `<run_dir>/beacons.jsonl` (`RunTelemetry`'s
    constructor). No file is made until an armed site writes a row."""
    global _beacon_ledger
    if run_dir is None:
        return
    from .ledger import MetricsLedger

    with _lock:
        _beacon_ledger = MetricsLedger(Path(run_dir) / BEACONS_FILENAME)


def detach_beacon_run_dir(run_dir) -> None:
    """Stop sending beacon rows to `<run_dir>/beacons.jsonl`
    (`RunTelemetry.close`, after a last drain); an attachment to another
    run's file stays."""
    global _beacon_ledger
    with _lock:
        ledger = _beacon_ledger
        if ledger is not None and ledger.path == Path(run_dir) / BEACONS_FILENAME:
            _beacon_ledger = None


def note_dispatch(program: str) -> None:
    """Name the program the host is about to enqueue. A host row takes
    the name at once; a card row takes the name current when its beacon
    was enqueued, so the overlapped loop's streams attribute their rows
    to their own dispatch as far as the host's order of enqueues goes."""
    global _current_program
    _current_program = program


def write_beacon_row(phase: str, index: int, program: "str | None") -> None:
    """Append one beacon row to the attached ledger (none: dropped)."""
    ledger = _beacon_ledger
    if ledger is None:
        return
    ledger.append(
        {
            "kind": BEACON_KIND,
            "program": program,
            "phase": phase,
            "index": index,
            "t_mono": time.monotonic(),
            "time": time.time(),
            "pid": os.getpid(),
        }
    )


def emit_beacon(phase: str, index, every: int = 1, device=None) -> None:
    """A beacon site. Nothing unless beacons are armed and `index` is a
    multiple of `every`. Then, on a CUDA `device`, one launch of the
    beacon writer on the current stream (its row is written when the
    stream gets there); anywhere else, the row at once."""
    if not beacons_armed():
        return
    i = int(index)
    if i % max(1, int(every)):
        return
    if device is not None and getattr(device, "type", None) == "cuda":
        from ..ops.beacon import ring_for

        ring_for(device).emit(phase, i, _current_program)
        return
    try:
        write_beacon_row(phase, i, _current_program)
    except Exception:  # a beacon must never end a dispatch
        logger.debug("beacon write failed (%s)", phase, exc_info=True)


def drain_beacons() -> int:
    """Turn every slot the card has published into rows now (the wedge
    path calls it before it reads `last_beacon`); returns the rows
    written. Nothing to do off the card."""
    import sys

    mod = sys.modules.get(__package__.rsplit(".", 1)[0] + ".ops.beacon")
    return mod.drain_all() if mod is not None else 0


def _stop_rings() -> None:
    import sys

    mod = sys.modules.get(__package__.rsplit(".", 1)[0] + ".ops.beacon")
    if mod is not None:
        mod.stop_all()


# --- readers (no torch) ------------------------------------------------------


def read_beacons(path) -> list[dict]:
    """Every parseable beacon row of a `beacons.jsonl` (a torn tail is
    skipped; a missing file gives an empty list)."""
    from .ledger import iter_jsonl_records

    return list(iter_jsonl_records(path, kinds={BEACON_KIND}))


def last_beacon(run_dir_or_path) -> "dict | None":
    """The newest beacon row of a run, or None (no file, never armed):
    what `wedge_report.json` carries."""
    if run_dir_or_path is None:
        return None
    path = Path(run_dir_or_path)
    if path.is_dir():
        path = path / BEACONS_FILENAME
    rows = read_beacons(path)
    return rows[-1] if rows else None


def describe_beacon(row: "dict | None") -> "str | None":
    """One line for a wedge verdict: `megastep/t16_k8 phase=search_wave
    index=37`."""
    if not isinstance(row, dict):
        return None
    program = row.get("program") or "?"
    return f"{program} phase={row.get('phase')} index={row.get('index')}"


# --- host folds --------------------------------------------------------------


def _finite(value) -> "float | None":
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    if value != value or value in (float("inf"), float("-inf")):
        return None
    return float(value)


def unpack_search_stats(pack) -> "dict | None":
    """A fetched search stat-pack, (..., SEARCH_PACK_SIZE), as the JAX
    package's dict of leaves: `depth_hist` (..., DEPTH_BINS) and one
    (...)-shaped array per scalar. None passes through."""
    if pack is None:
        return None
    import numpy as np

    arr = np.asarray(pack, dtype=np.float64)
    out = {"depth_hist": arr[..., :DEPTH_BINS]}
    for i, key in enumerate(SEARCH_SCALARS):
        out[key] = arr[..., DEPTH_BINS + i]
    return out


def unpack_per_stats(pack) -> "dict | None":
    """A fetched PER stat-pack, (len(PER_SCALARS),), as the JAX leg's
    rounded floats."""
    if pack is None:
        return None
    return {key: round(float(v), 6) for key, v in zip(PER_SCALARS, list(pack))}


def fold_search_stats(stats) -> "dict | None":
    """Fold an unpacked search stat-pack (possibly (T,)-stacked by a
    rollout chunk) into plain floats for the ledger record. Scalars fold
    as the mean over the stacking axis, `value_abs_max` as the max; the
    depth histogram sums."""
    if not isinstance(stats, dict) or not stats:
        return None
    import numpy as np

    out: dict = {}
    for key, reduce_fn in (
        ("root_entropy", np.mean),
        ("root_concentration", np.mean),
        ("occupancy", np.mean),
        ("reuse_frac", np.mean),
        ("value_abs_max", np.max),
    ):
        if key in stats:
            try:
                out[key] = round(float(reduce_fn(np.asarray(stats[key]))), 6)
            except (TypeError, ValueError):
                continue
    if "depth_hist" in stats:
        try:
            hist = np.asarray(stats["depth_hist"], dtype=np.float64)
            if hist.ndim > 1:  # (T, BINS) stacked by the chunk
                hist = hist.sum(axis=tuple(range(hist.ndim - 1)))
            out["depth_hist"] = [round(float(v), 1) for v in hist.tolist()]
        except (TypeError, ValueError):
            pass
    return out or None


def merge_search_folds(folds: list) -> "dict | None":
    """Merge folded search legs (the serve loop keeps one per dispatch
    between ticks) into one: scalars average, `value_abs_max` maxes,
    depth histograms sum."""
    rows = [f for f in folds if isinstance(f, dict) and f]
    if not rows:
        return None
    out: dict = {}
    for key in ("root_entropy", "root_concentration", "occupancy", "reuse_frac"):
        vals = [v for v in (_finite(r.get(key)) for r in rows) if v is not None]
        if vals:
            out[key] = round(sum(vals) / len(vals), 6)
    vmax = [v for v in (_finite(r.get("value_abs_max")) for r in rows) if v is not None]
    if vmax:
        out["value_abs_max"] = round(max(vmax), 6)
    hists = [r["depth_hist"] for r in rows if isinstance(r.get("depth_hist"), list)]
    if hists:
        width = max(len(h) for h in hists)
        summed = [0.0] * width
        for h in hists:
            for i, v in enumerate(h):
                f = _finite(v)
                if f is not None:
                    summed[i] += f
        out["depth_hist"] = [round(v, 1) for v in summed]
    return out or None


def rollout_chunk_stats(endings, rewards) -> "dict | None":
    """The rollout leg from arrays the chunk's fetch already carried:
    episode terminations per move of T and the reward extremes."""
    import numpy as np

    try:
        ends = np.asarray(endings)
        rew = np.asarray(rewards, dtype=np.float64)
    except (TypeError, ValueError):
        return None
    if ends.ndim < 2 or rew.size == 0:
        return None
    terms = (ends != 0).sum(axis=tuple(range(1, ends.ndim)))
    return {
        "terminations_per_step": [int(v) for v in terms.tolist()],
        "reward_min": round(float(rew.min()), 6),
        "reward_max": round(float(rew.max()), 6),
    }


def device_stats_record(
    step: int,
    program: "str | None" = None,
    search: "dict | None" = None,
    rollout: "dict | None" = None,
    per: "dict | None" = None,
    learner: "dict | None" = None,
    serve: "dict | None" = None,
    now: "float | None" = None,
) -> "dict | None":
    """One `kind:"device_stats"` ledger line; None when every leg is
    empty."""
    legs = {
        k: v
        for k, v in (
            ("search", search),
            ("rollout", rollout),
            ("per", per),
            ("learner", learner),
            ("serve", serve),
        )
        if v
    }
    if not legs:
        return None
    record = {
        "kind": DEVICE_STATS_KIND,
        "step": step,
        "time": time.time() if now is None else now,
        **legs,
    }
    if program:
        record["program"] = program
    return record


def summarize_device_stats(records: list) -> "dict | None":
    """A run's `device_stats` records folded into `cli perf`'s `ds_*`
    fields; None without records."""
    rows = [r for r in records if isinstance(r, dict) and r.get("kind") == DEVICE_STATS_KIND]
    if not rows:
        return None

    def leg(name: str, key: str) -> list:
        out = []
        for r in rows:
            v = _finite((r.get(name) or {}).get(key))
            if v is not None:
                out.append(v)
        return out

    def _mean(vals: list) -> "float | None":
        return round(sum(vals) / len(vals), 6) if vals else None

    def _max(vals: list) -> "float | None":
        return round(max(vals), 6) if vals else None

    def _min(vals: list) -> "float | None":
        return round(min(vals), 6) if vals else None

    return {
        "ds_records": len(rows),
        "ds_root_entropy": _mean(leg("search", "root_entropy")),
        "ds_root_entropy_min": _min(leg("search", "root_entropy")),
        "ds_root_concentration": _mean(leg("search", "root_concentration")),
        "ds_value_abs_max": _max(leg("search", "value_abs_max")),
        "ds_tree_occupancy": _mean(leg("search", "occupancy")),
        "ds_tree_occupancy_max": _max(leg("search", "occupancy")),
        "ds_reuse_frac": _mean(leg("search", "reuse_frac")),
        "ds_reward_min": _min(leg("rollout", "reward_min")),
        "ds_reward_max": _max(leg("rollout", "reward_max")),
        "ds_priority_skew": _max(leg("per", "priority_skew")),
        "ds_is_weight_min": _min(leg("per", "is_weight_min")),
        "ds_grad_norm_max": _max(leg("learner", "grad_norm_max")),
        "ds_update_norm_max": _max(leg("learner", "update_norm_max")),
        "ds_serve_root_entropy": _mean(leg("serve", "root_entropy")),
    }


def device_stats_json(records: list) -> "dict | None":
    """The summary fold plus the newest raw record (its depth histogram
    included): the JAX package's benchmark block."""
    summary = summarize_device_stats(records)
    if summary is None:
        return None
    newest = next(
        (
            r
            for r in reversed(records)
            if isinstance(r, dict) and r.get("kind") == DEVICE_STATS_KIND
        ),
        None,
    )
    if newest is not None:
        summary["last_record"] = json.loads(json.dumps(newest, default=str))
    return summary
