"""Fleet trace merge: counterpart of `alphatriangle_tpu/telemetry/
merge.py`, one Perfetto timeline from the router to the card.

Every process of a fleet run writes its own evidence: the torch-free
parent a `fleet.jsonl` and a `flight.jsonl` of its `fleet/route`
brackets, each replica a `trace.json` span ring (`replica/episode`) and
a `flight.jsonl` of its `serve/b<B>` dispatches. `merge_fleet_trace`
(`cli trace <run> --fleet`) fuses them into one Chrome / Perfetto trace
(`trace_fleet.json`):

- per-process lanes: the parent and every replica incarnation get a pid
  group with `process_name` metadata; concurrent `fleet/route` spans are
  packed onto a minimal set of router lanes (greedy interval packing),
  so overlapping requests never stack on one track;
- clock alignment: flight records carry `(t_mono, time)` pairs and the
  replicas report the same pair in their ready lines, so each process's
  monotonic clock is placed on the shared wall clock by
  `median(time - t_mono)` over its samples; durations are monotonic
  deltas, so skewed monotonic epochs cannot give negative durations;
- flow arrows: the trace id minted per routed request
  (`telemetry/tracectx.py`) links the parent's `fleet/route` span to the
  replica spans that served it (`replica/episode` spans and `serve/b<B>`
  brackets whose `trace_ids` name the wave), as Chrome flow events
  (`ph: s/t/f`);
- lifecycle instants: shed / retry / hedge / death / respawn events of
  `fleet.jsonl` on the parent's lifecycle lane, each with its trace id.

The readers are tolerant: records without ids merge (they draw no
arrows), a SIGKILLed replica that never exported its `trace.json` still
contributes its flight spans, and a missing file skips its lane. Stdlib
only: the merge runs beside a dead fleet, as `cli doctor` does.
"""

import json
import logging
from collections import defaultdict
from pathlib import Path

from .flight import FLIGHT_FILENAME, read_flight

logger = logging.getLogger(__name__)

MERGED_TRACE_FILENAME = "trace_fleet.json"

#: The `cat` of every flow event of the merge.
FLOW_CAT = "fleet-flow"

_PARENT_PID_FALLBACK = 1


def _median_offset(samples: list) -> "float | None":
    """median(wall - mono) over (t_mono, time) pairs — one process's
    monotonic->wall calibration constant. Median, not mean: a single
    sample taken across a descheduling blip must not tilt the lane."""
    diffs = sorted(
        float(w) - float(m)
        for m, w in samples
        if isinstance(m, (int, float)) and isinstance(w, (int, float))
    )
    if not diffs:
        return None
    return diffs[len(diffs) // 2]


def _pair_flight(records: list) -> "tuple[list, list]":
    """(sealed intent/seal pairs, unsealed intents) from one flight
    ring, tolerant of legacy and torn records."""
    intents: dict = {}
    pairs = []
    for r in records:
        phase = r.get("phase")
        if phase == "intent":
            intents[r.get("seq")] = r
        elif phase == "seal":
            intent = intents.pop(r.get("seq"), None)
            if intent is not None:
                pairs.append((intent, r))
    return pairs, list(intents.values())


def _clock_samples(records: list) -> dict:
    """pid -> [(t_mono, time)] calibration samples from flight records
    (seals inherit their intent's pid via the pair walk)."""
    samples: dict = defaultdict(list)
    pairs, torn = _pair_flight(records)
    for intent, seal in pairs:
        pid = intent.get("pid")
        samples[pid].append((intent.get("t_mono"), intent.get("time")))
        samples[pid].append((seal.get("t_mono"), seal.get("time")))
    for intent in torn:
        samples[intent.get("pid")].append(
            (intent.get("t_mono"), intent.get("time"))
        )
    return samples


def _assign_lanes(spans: list) -> list:
    """Greedy interval packing: returns one lane index per (ts, dur)
    span so overlapping spans never share a lane (Chrome complete
    events on one tid must nest, and concurrent routed requests
    don't)."""
    order = sorted(range(len(spans)), key=lambda i: spans[i][0])
    lane_end: list = []
    lanes = [0] * len(spans)
    for i in order:
        ts, dur = spans[i]
        for lane, end in enumerate(lane_end):
            if ts >= end:
                lane_end[lane] = ts + dur
                lanes[i] = lane
                break
        else:
            lane_end.append(ts + dur)
            lanes[i] = len(lane_end) - 1
    return lanes


def _flight_lane_events(
    records: list,
    *,
    pid: int,
    tid_base: int,
    offsets: dict,
    span_index: "dict | None" = None,
    lane_pack: bool = False,
):
    """Chrome events for one process's flight ring: calibrated complete
    spans for sealed pairs, instants for unsealed intents. When
    `span_index` is given, every span with trace ids registers itself
    there (trace_id -> [(pid, tid, ts_us, dur_us)]) for flow drawing."""
    pairs, torn = _pair_flight(records)
    placed = []
    for intent, seal in pairs:
        rec_pid = intent.get("pid", pid)
        offset = offsets.get(rec_pid)
        t_mono = intent.get("t_mono")
        if offset is not None and isinstance(t_mono, (int, float)):
            ts = float(t_mono) + offset
        else:
            ts = float(intent.get("time") or 0.0)
        dur = max(
            0.0,
            float(seal.get("t_mono") or 0.0) - float(t_mono or 0.0),
        )
        placed.append((intent, seal, ts, dur))
    lanes = (
        _assign_lanes([(ts, dur) for _, _, ts, dur in placed])
        if lane_pack
        else None
    )
    events = []
    max_tid = tid_base
    for i, (intent, seal, ts, dur) in enumerate(placed):
        rec_pid = intent.get("pid", pid) or pid
        tid = tid_base + (lanes[i] if lanes is not None else 0)
        max_tid = max(max_tid, tid)
        ts_us = int(ts * 1e6)
        dur_us = int(dur * 1e6)
        args = {
            "family": intent.get("family"),
            "seq": intent.get("seq"),
            "ok": seal.get("ok", True),
        }
        trace_ids = []
        for key in ("trace_id", "span_id", "parent_id"):
            if intent.get(key):
                args[key] = intent[key]
        if intent.get("trace_id"):
            trace_ids.append(str(intent["trace_id"]))
        if isinstance(intent.get("trace_ids"), list):
            args["trace_ids"] = intent["trace_ids"]
            trace_ids.extend(str(t) for t in intent["trace_ids"])
        if intent.get("avals"):
            args["avals"] = intent["avals"]
        events.append(
            {
                "name": str(intent.get("program")),
                "ph": "X",
                "ts": ts_us,
                "dur": dur_us,
                "pid": rec_pid,
                "tid": tid,
                "cat": "flight",
                "args": args,
            }
        )
        if span_index is not None:
            for trace_id in trace_ids:
                span_index[trace_id].append((rec_pid, tid, ts_us, dur_us))
    for intent in torn:
        offset = offsets.get(intent.get("pid", pid))
        t_mono = intent.get("t_mono")
        if offset is not None and isinstance(t_mono, (int, float)):
            ts = float(t_mono) + offset
        else:
            ts = float(intent.get("time") or 0.0)
        events.append(
            {
                "name": f"unsealed:{intent.get('program')}",
                "ph": "i",
                "s": "t",
                "ts": int(ts * 1e6),
                "pid": intent.get("pid", pid) or pid,
                "tid": tid_base,
                "cat": "flight",
                "args": {
                    k: intent[k]
                    for k in ("seq", "family", "trace_id")
                    if intent.get(k) is not None
                },
            }
        )
    return events, max_tid


def _load_trace_events(path: Path) -> list:
    """traceEvents from one replica's trace.json (object or bare-array
    form); [] when missing/corrupt — a SIGKILLed replica never exported
    one, and its flight ring still draws the lane."""
    try:
        data = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return []
    events = data.get("traceEvents") if isinstance(data, dict) else data
    return [e for e in (events or []) if isinstance(e, dict)]


def merge_fleet_trace(
    run_dir: "Path | str", out_path: "Path | str | None" = None
) -> dict:
    """Fuse a fleet-parent run dir into one Perfetto trace file.

    Returns a summary dict: output path, per-lane event counts, flow
    arrow count, the distinct trace_ids linked across processes, and
    the per-process clock offsets used. Raises FileNotFoundError when
    the dir shows no fleet evidence (no fleet.jsonl) — `cli trace
    --fleet` maps that to exit 1.
    """
    from ..serving.fleet import FLEET_FILENAME, read_fleet_events

    run_dir = Path(run_dir)
    if not (run_dir / FLEET_FILENAME).exists():
        raise FileNotFoundError(
            f"{run_dir / FLEET_FILENAME} not found — not a fleet-parent "
            "run dir"
        )
    out_path = (
        Path(out_path) if out_path else run_dir / MERGED_TRACE_FILENAME
    )
    fleet_events = read_fleet_events(run_dir)
    parent_flight = read_flight(run_dir / FLIGHT_FILENAME)

    # --- clock calibration: pid -> median(wall - mono) ----------------
    samples = _clock_samples(parent_flight)
    replica_dirs = sorted(
        p for p in run_dir.glob("replica_*") if p.is_dir()
    )
    replica_flight: dict = {}
    for rdir in replica_dirs:
        records = read_flight(rdir / FLIGHT_FILENAME)
        replica_flight[rdir.name] = records
        for pid, pairs in _clock_samples(records).items():
            samples[pid].extend(pairs)
        try:
            health = json.loads((rdir / "health.json").read_text())
            samples[health.get("pid")].append(
                (health.get("monotonic"), health.get("time"))
            )
        except (OSError, ValueError):
            pass
    # Replica ready lines, ledgered by the parent with the replica's
    # own clock pair — the calibration source that exists even for an
    # incarnation whose ring stayed empty.
    for e in fleet_events:
        if e.get("event") == "replica-ready" and e.get("replica_pid"):
            samples[e.get("replica_pid")].append(
                (e.get("t_mono"), e.get("replica_time"))
            )
    offsets = {
        pid: off
        for pid, off in (
            (pid, _median_offset(pairs)) for pid, pairs in samples.items()
        )
        if off is not None
    }

    events: list = []
    meta: list = []
    # trace_id -> [(pid, tid, ts_us, dur_us)] of parent route spans.
    route_index: dict = defaultdict(list)
    # trace_id -> [(pid, tid, ts_us, dur_us)] of replica-side spans.
    replica_index: dict = defaultdict(list)

    # --- parent lane ---------------------------------------------------
    parent_pid = next(
        (
            e.get("pid")
            for e in fleet_events
            if isinstance(e.get("pid"), int)
        ),
        None,
    ) or next(
        (
            r.get("pid")
            for r in parent_flight
            if isinstance(r.get("pid"), int)
        ),
        _PARENT_PID_FALLBACK,
    )
    meta.append(
        {
            "name": "process_name",
            "ph": "M",
            "pid": parent_pid,
            "args": {"name": f"fleet parent ({run_dir.name})"},
        }
    )
    route_events, max_router_tid = _flight_lane_events(
        parent_flight,
        pid=parent_pid,
        tid_base=1,
        offsets=offsets,
        span_index=route_index,
        lane_pack=True,
    )
    events.extend(route_events)
    for tid in range(1, max_router_tid + 1):
        meta.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": parent_pid,
                "tid": tid,
                "args": {"name": f"router lane {tid - 1}"},
            }
        )
    lifecycle_tid = max_router_tid + 1
    meta.append(
        {
            "name": "thread_name",
            "ph": "M",
            "pid": parent_pid,
            "tid": lifecycle_tid,
            "args": {"name": "fleet lifecycle"},
        }
    )
    for e in fleet_events:
        t = e.get("time")
        if not isinstance(t, (int, float)):
            continue
        args = {
            k: e[k]
            for k in (
                "replica",
                "rejection",
                "verdict",
                "attempt",
                "primary",
                "backup",
                "trace_id",
                "request_kind",
            )
            if e.get(k) is not None
        }
        events.append(
            {
                "name": f"fleet/{e.get('event')}",
                "ph": "i",
                "s": "t",
                "ts": int(float(t) * 1e6),
                "pid": parent_pid,
                "tid": lifecycle_tid,
                "cat": "fleet",
                "args": args,
            }
        )

    # --- replica lanes --------------------------------------------------
    for rdir in replica_dirs:
        records = replica_flight.get(rdir.name, [])
        lane_pids = sorted(
            {
                r.get("pid")
                for r in records
                if r.get("phase") == "intent"
                and isinstance(r.get("pid"), int)
            }
        )
        tracer_events = _load_trace_events(rdir / "trace.json")
        tracer_pids = {
            e.get("pid")
            for e in tracer_events
            if isinstance(e.get("pid"), int)
        }
        for pid in sorted(set(lane_pids) | tracer_pids):
            meta.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "args": {"name": f"replica {rdir.name} (pid {pid})"},
                }
            )
        if records:
            flight_events, _ = _flight_lane_events(
                records,
                pid=lane_pids[0] if lane_pids else _PARENT_PID_FALLBACK,
                tid_base=0,
                offsets=offsets,
                span_index=replica_index,
            )
            events.extend(flight_events)
        for ev in tracer_events:
            events.append(ev)
            args = ev.get("args") or {}
            trace_id = args.get("trace_id")
            if ev.get("ph") == "X" and trace_id:
                replica_index[str(trace_id)].append(
                    (
                        ev.get("pid"),
                        ev.get("tid"),
                        int(ev.get("ts") or 0),
                        int(ev.get("dur") or 0),
                    )
                )

    # --- flow arrows: router span -> replica spans ----------------------
    flows = 0
    flow_trace_ids = []
    for trace_id, targets in sorted(replica_index.items()):
        sources = route_index.get(trace_id)
        if not sources:
            continue
        src = min(sources, key=lambda s: s[2])
        flow_trace_ids.append(trace_id)
        events.append(
            {
                "name": "route",
                "ph": "s",
                "id": trace_id,
                "ts": src[2],
                "pid": src[0],
                "tid": src[1],
                "cat": FLOW_CAT,
            }
        )
        ordered = sorted(targets, key=lambda t: t[2])
        floor_ts = src[2]
        for j, (pid, tid, ts_us, _dur) in enumerate(ordered):
            # Flow steps must be non-decreasing in ts; clamping keeps a
            # calibration-residual jitter from breaking causal order.
            floor_ts = max(floor_ts, ts_us)
            events.append(
                {
                    "name": "route",
                    "ph": "t" if j < len(ordered) - 1 else "f",
                    "bp": "e",
                    "id": trace_id,
                    "ts": floor_ts,
                    "pid": pid,
                    "tid": tid,
                    "cat": FLOW_CAT,
                }
            )
            flows += 1

    payload = {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "merge": "alphatriangle.fleet.v1",
            "run_dir": str(run_dir),
            "clock_offsets": {
                str(pid): round(off, 6) for pid, off in offsets.items()
            },
        },
    }
    out_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = out_path.with_suffix(out_path.suffix + ".tmp")
    tmp.write_text(json.dumps(payload))
    tmp.replace(out_path)
    return {
        "path": str(out_path),
        "events": len(events),
        "processes": len(
            {m["pid"] for m in meta if m["name"] == "process_name"}
        ),
        "replicas": len(replica_dirs),
        "route_spans": sum(len(v) for v in route_index.values()),
        "flows": flows,
        "flow_trace_ids": flow_trace_ids,
        "clock_offsets": {
            str(pid): round(off, 6) for pid, off in offsets.items()
        },
    }
