"""Continuous-batching policy service over the lockstep wave search:
counterpart of `alphatriangle_tpu/serving/service.py`.

Many concurrent game sessions multiplex onto ONE batched
`BatchedMCTS.search` over the full slot array. Requests queue between
dispatches; each dispatch serves every pending session with one search
and one masked step, then fetches its results to the host in one
transfer. `reload_weights` swaps the served net's weights between
dispatches.

With a `ladder` (`serving/buckets.py`) the slot array's width walks
between rungs, between dispatches: up one rung when the fill of the
last `sustain` dispatches averages at or above `HIGH_WATER`, or at once
when an admission would not fit the current width but fits a higher
rung; down one when it averages at or below `LOW_WATER` and the live
sessions fit the lower rung. A switch migrates the live sessions
lowest-old-slot-first (`SessionSlots.migrate`), drops every carried
tree and clears the walk window. The search has no per-width program,
so a rung is warm (`warm_rung`) once one search at its width has run on
the card: cuBLAS / cuDNN have chosen their algorithms for that batch
and the caching allocator holds its blocks, and the first dispatch
after a switch costs the migration, not a cold start. The dispatch keys
do not depend on the rung. Without a ladder the service keeps one rung.

With `MCTSConfig.tree_reuse` each lane carries its promoted search tree
across dispatches on the device: a dispatch searches from the carried
lanes the host still trusts (`_carry_ok`), then promotes the subtree of
the action the masked step plays. A lane's carry is cleared when its
session opens or closes, when its game ends, when it was not served
(its promotion was for a move it never played), on every weight reload
(the carried statistics came from the old net) and, for every lane, at
a rung switch.

Each served action is the search's own choice (`mcts.root_actions`):
the visit argmax, or a `GumbelMCTS`'s (usually `exploit=True`)
`selected_action`.

Under a reduced `INFERENCE_PRECISION` the search reads the net's
weights through `_serve_variables`: an `InferenceNet` (bf16, or int8
dequantized at each evaluation) cast once per (weights version, reload
count) and kept for the dispatches that follow, cast again after
`reload_weights` (`nn/precision.py`). Under float32 the search reads
the net's module itself.

`emitter` (None by default) is the league's trajectory sink
(`league/emitter.py`): when set, each dispatch hands it the pre-step
states, the search output and the served sessions, and each closed
session its summary; a failing emitter is logged and serving goes on.

`serve_stats(drain)` reports occupancy and the current tick window's
request count, rate, batch fill and the percentiles of batch wall,
queue wait and move latency; a drain starts a new window. With a
`telemetry` (`telemetry.RunTelemetry`, built by `build_serve_telemetry`)
`tick()` drains the window into one `kind: "util"` ledger record and
the heartbeat, and each dispatch is bracketed in the flight ring as
`serve/b<slots>`: the intent before the search, the seal after the one
host fetch, so a wedge names the program and the `trace_ids` it was
serving. Inside the bracket, before the search, sits the env-gated
`serve-dispatch` fault site (`supervise/faults.py`), then the dispatch
names its program for beacon rows (`note_dispatch`).

Device stats: when the search was built with stat-packs on (the serve
path never sets the flag; `ALPHATRIANGLE_DEVICE_STATS=1`, or a process
whose training setup set it, turns them on, as in the JAX package), each
dispatch's pack rides its one fetch and is folded into the tick window;
`tick()` merges the window into the serve leg, ledgers it as a
`kind:"device_stats"` record and mirrors its root entropy and occupancy
into the util record's gauges.
"""

import logging
import os
import threading
import time
from collections import deque

import numpy as np
import torch
from torch.profiler import record_function

from .. import rng
from ..mcts.search import CarriedTree
from ..nn import precision
from ..telemetry.device_stats import (
    beacons_armed,
    fold_search_stats,
    merge_search_folds,
    note_dispatch,
    unpack_search_stats,
)
from ..telemetry.flight import flight_span
from ..telemetry.roofline import note_program_cost, serve_cost
from ..utils.transfer import fetch
from .buckets import BucketLadder
from .session import SessionSlots

logger = logging.getLogger(__name__)

# The ladder's walk thresholds on the window's mean fill (the JAX
# service's defaults).
HIGH_WATER = 0.85
LOW_WATER = 0.25


def serve_program_name(slots: int) -> str:
    """The flight-ring name of the serve dispatch at one width:
    `serve/b<B>`, the JAX package's spelling."""
    return f"serve/b{int(slots)}"


def _pct(values: list, q: float) -> "float | None":
    vals = sorted(values)
    if not vals:
        return None
    return float(vals[min(len(vals) - 1, max(0, round(q * (len(vals) - 1))))])


class PolicyService:
    """Request queue + micro-batcher over one `SessionSlots` array.

    Any thread may open/close sessions and enqueue move requests
    (lock-guarded); one caller drives `dispatch()` in a loop. Admission
    beyond the top rung's slot count raises: back-pressure belongs to
    the caller.
    """

    def __init__(
        self,
        env,
        extractor,
        net,
        mcts,
        slots: int,
        rng_seed: int = 0,
        pad_seed: int = 0,
        clock=time.monotonic,
        ladder=None,
        sustain: int = 3,
        telemetry=None,
    ):
        self.env = env
        self.extractor = extractor
        self.net = net
        self.mcts = mcts
        self.telemetry = telemetry
        # The run's flight recorder; None without telemetry.
        self.flight = getattr(telemetry, "flight", None)
        self.emitter = None
        self._clock = clock
        # `slots` is the starting rung and always a rung.
        self.ladder = BucketLadder.single(slots) if ladder is None else BucketLadder.from_spec(
            ladder, base=slots
        )
        self.sustain = max(1, int(sustain))
        self.rung_switches = 0
        # The fills of the last `sustain` dispatches: the walk's window.
        self._ladder_fill: deque[float] = deque(maxlen=self.sustain)
        self._pad_seed = int(pad_seed)
        self.sessions = SessionSlots(env, slots, pad_seed=pad_seed)
        self._base_rng = rng.PRNGKey(rng_seed)
        self._lock = threading.RLock()
        self._queue: deque[int] = deque()  # sids with a pending request
        # sid -> the trace fields of the request driving that session,
        # named by the dispatch bracket and the session's results.
        self._session_trace: dict[int, dict] = {}
        self.dispatch_count = 0
        self.requests_total = 0
        self.episodes_done_total = 0
        self.simulations_total = 0
        self.reused_visits_total = 0
        self.weight_reloads = 0
        self.batch_ms: list[float] = []  # per-dispatch wall time, whole run
        # The tick window (`serve_stats(drain=True)` starts a new one).
        self._win_wait_ms: list[float] = []
        self._win_lat_ms: list[float] = []
        self._win_batch_ms: list[float] = []
        self._win_fill: list[float] = []
        self._win_requests = 0
        self._last_tick_t = clock()
        # One stat-pack fold per dispatch (a search built with them) in
        # the window, merged into a serve leg at a drain.
        self._win_device_stats: list[dict] = []
        self._last_serve_ds: "dict | None" = None
        # The last dispatch's search output and, under reuse, its (B,)
        # inherited root visits (device tensors, no fetch).
        self.last_output = None
        self.last_reused = None
        self._tree_reuse = bool(mcts.config.tree_reuse)
        self._carry_ok = np.zeros(slots, dtype=bool)
        self._carried = mcts.zero_carried(self.sessions.states) if self._tree_reuse else None
        self._reduced = precision.inference_dtype(extractor.model_config) != torch.float32
        # (weights version, reload count) -> the InferenceNet the search reads.
        self._cast_variables: "tuple[tuple, precision.InferenceNet] | None" = None

    @property
    def max_slots(self) -> int:
        """The most sessions the service can ever hold: the top rung."""
        return self.ladder.max_rung

    # --- warm start -------------------------------------------------------

    def warm(self) -> None:
        """Warm every rung of the ladder (`warm_rung`)."""
        for rung in self.ladder.rungs:
            self.warm_rung(rung)

    def warm_rung(self, rung: int) -> None:
        """One search (and, under reuse, one promotion) over a padding
        array of `rung` frozen lanes, its outputs dropped: the width's
        library choices and allocator blocks are then in place. Touches
        no session, counter or carried tree."""
        rung = int(rung)
        if rung not in self.ladder:
            raise ValueError(f"rung {rung} is not on the ladder {self.ladder.rungs}")
        states = SessionSlots(self.env, rung, pad_seed=self._pad_seed).states
        key = rng.PRNGKey(0)
        with self._lock:
            if self._reduced:
                self.mcts.model = self._serve_variables()
            if self._tree_reuse:
                out, tree, _ = self.mcts._search_carried(states, key, self.mcts.zero_carried(states))
                self.mcts.promote(tree, self.mcts.root_actions(out))
            else:
                self.mcts.root_actions(self.mcts.search(states, key))
        if states.done.is_cuda:
            # graftlint: allow(host-sync-in-hot-path) the warm-up waits for its programs, once a rung
            torch.cuda.synchronize(states.done.device)

    # --- the bucket ladder --------------------------------------------------

    def _switch_rung(self, new_rung: int, reason: str) -> None:
        """Move to the `new_rung`-lane array between dispatches: migrate
        the live sessions, drop every carried tree (`_carry_ok` all
        False, fresh zero trees at the new width) and clear the walk
        window. Caller holds the lock."""
        old = self.sessions.slots
        if new_rung == old:
            return
        self.sessions = self.sessions.migrate(new_rung, pad_seed=self._pad_seed)
        self._carry_ok = np.zeros(new_rung, dtype=bool)
        if self._tree_reuse:
            self._carried = self.mcts.zero_carried(self.sessions.states)
        self._ladder_fill.clear()
        self.rung_switches += 1
        logger.info(
            "serve: rung switch b%d -> b%d (%s; live=%d queue=%d)",
            old, new_rung, reason, self.sessions.live_count, self.queue_depth,
        )

    def _maybe_walk(self) -> None:
        """The windowed walk, between dispatches (caller holds the lock):
        up when the window's mean fill is at or above `HIGH_WATER`, down
        when it is at or below `LOW_WATER` and the live sessions fit the
        lower rung."""
        if len(self._ladder_fill) < self.sustain:
            return
        fill = sum(self._ladder_fill) / len(self._ladder_fill)
        rung = self.sessions.slots
        if fill >= HIGH_WATER and rung < self.ladder.max_rung:
            self._switch_rung(self.ladder.up(rung), f"fill {fill:.2f} >= high-water")
        elif fill <= LOW_WATER and rung > self.ladder.min_rung:
            lower = self.ladder.down(rung)
            if self.sessions.live_count <= lower:
                self._switch_rung(lower, f"fill {fill:.2f} <= low-water")

    def _grow_for(self, needed: int) -> None:
        """Walk up before an admission that overflows the current width
        but fits a higher rung (caller holds the lock)."""
        demand = self.sessions.live_count + int(needed)
        if self.sessions.free_count >= needed or demand > self.ladder.max_rung:
            return
        target = self.ladder.rung_for(demand)
        if target > self.sessions.slots:
            self._switch_rung(target, f"admission demand {demand}")

    # --- session lifecycle --------------------------------------------

    def open_session(self, reset_key: "torch.Tensor | None" = None, seed: "int | None" = None):
        """Admit one session (fresh game), walking the ladder up when the
        current width is full; raises when every slot of the top rung is
        taken."""
        if reset_key is None:
            reset_key = rng.PRNGKey(0 if seed is None else seed)
        with self._lock:
            self._grow_for(1)
            s = self.sessions.admit(reset_key)
            self._carry_ok[s.slot] = False
            return s

    def open_sessions(self, reset_keys: torch.Tensor) -> list:
        with self._lock:
            self._grow_for(int(reset_keys.shape[0]))
            admitted = self.sessions.admit_many(reset_keys)
            for s in admitted:
                self._carry_ok[s.slot] = False
            return admitted

    def set_session_trace(self, sid: int, fields: "dict | None") -> None:
        """Attach (or clear) the trace fields of the request driving
        session `sid`: the dispatch bracket names them, and the
        session's results carry its `trace_id`."""
        with self._lock:
            if fields:
                self._session_trace[sid] = dict(fields)
            else:
                self._session_trace.pop(sid, None)

    def close_session(self, sid: int) -> dict:
        with self._lock:
            s = self.sessions.session(sid)
            s.pending_since = None
            self._session_trace.pop(sid, None)
            self._carry_ok[s.slot] = False
            summary = self.sessions.retire(sid)
            if sid in self._queue:
                self._queue.remove(sid)
            if self.emitter is not None:
                try:
                    self.emitter.on_session_close(sid, summary)
                except Exception:
                    logger.exception("trajectory emitter failed closing session %d", sid)
            return summary

    def request_move(self, sid: int) -> None:
        """Enqueue one move request; a session holds at most one."""
        with self._lock:
            s = self.sessions.session(sid)
            if s.pending_since is not None:
                raise RuntimeError(f"session {sid} already has a pending move")
            s.pending_since = self._clock()
            self._queue.append(sid)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    # --- weights --------------------------------------------------------

    def reload_weights(self, state_dict: "dict | None" = None) -> int:
        """Swap the served weights between dispatches (`None` records a
        reload installed into the net externally). The search reads the
        net's module from the next dispatch on. Returns the count."""
        with self._lock:
            if state_dict is not None:
                self.net.set_weights(state_dict)
            live = getattr(self.net, "live", None)  # stub nets hold no weights
            if live is not None:
                self.mcts.model = live.model
            self.weight_reloads += 1
            self._carry_ok[:] = False
            return self.weight_reloads

    def _serve_variables(self):
        """The weights the dispatch's search reads: the net's module
        under float32; else its `InferenceNet`, memoized per (weights
        version, reload count), so a reload casts again."""
        if not self._reduced:
            return self.net.model
        key = (self.net.weights_version, self.weight_reloads)
        if self._cast_variables is None or self._cast_variables[0] != key:
            cast = precision.InferenceNet(self.net.model, self.extractor.model_config)
            self._cast_variables = (key, cast)
        return self._cast_variables[1]

    # --- the micro-batch dispatch ---------------------------------------

    def _search_step(self, mask: np.ndarray, key: torch.Tensor):
        """One search over the slot array, the masked step, and the one
        host fetch of every result array (caller holds the lock).
        Returns (search output, reused root visits or None, the
        pre-step states, the fetched host rows: actions, rewards, dones,
        scores and the reused visits, the fetched stat-pack or None)."""
        reused = None
        if self._reduced:
            self.mcts.model = self._serve_variables()
        if self._tree_reuse:
            ok = torch.from_numpy(self._carry_ok).to(self.mcts.device)
            c = self._carried
            carried = CarriedTree(tree=c.tree, valid=c.valid & ok, base=c.base)
            out, tree, reused = self.mcts._search_carried(self.sessions.states, key, carried)
            # The promotion follows the action the masked step plays.
            actions = self.mcts.root_actions(out)
            self._carried = self.mcts.promote(tree, actions)
        else:
            out = self.mcts.search(self.sessions.states, key)
            actions = self.mcts.root_actions(out)
        # The positions the search ran on (step installs new tensors).
        pre_states = self.sessions.states
        with record_function("serve.step"):
            rewards, dones = self.sessions.step(actions, mask)
        with record_function("serve.fetch"):
            rows = [
                actions.to(torch.float32),
                rewards,
                dones.to(torch.float32),
                self.sessions.states.score,
            ]
            if reused is not None:
                rows.append(reused)
            if out.stats is None:
                # graftlint: allow(host-sync-in-hot-path) the dispatch's one fetch
                host, pack = torch.stack(rows).cpu().numpy(), None
            else:  # the stat-pack rides the same copy
                # graftlint: allow(host-sync-in-hot-path) the dispatch's one fetch
                host, pack = fetch((torch.stack(rows), out.stats))
        return out, reused, pre_states, host, pack

    def dispatch(self, key: "torch.Tensor | None" = None) -> list[dict]:
        """Serve every pending request in ONE batched search + step.

        Returns one result dict per served request: action, reward,
        done, score, queue_wait_ms, latency_ms. Empty when the queue is
        empty."""
        with self._lock:
            if not self._queue:
                return []
            served = []
            mask = np.zeros(self.sessions.slots, dtype=bool)
            while self._queue:
                s = self.sessions.session(self._queue.popleft())
                mask[s.slot] = True
                served.append(s)
            t0 = self._clock()
            if key is None:
                key = rng.fold_in(self._base_rng, self.dispatch_count)
            # The trace_ids this dispatch serves, deduplicated in order.
            wave_trace_ids = list(dict.fromkeys(
                tid for s in served
                for tid in [self._session_trace.get(s.sid, {}).get("trace_id")] if tid
            ))
            # The seal follows the one host fetch: the bracket's wall is
            # the kernels', not their launches'.
            slots = self.sessions.slots
            note_program_cost(serve_program_name(slots), lambda: serve_cost(self, slots), f"b{slots}",
                              self.env.device.type)
            with flight_span(
                self.flight, "serve", serve_program_name(self.sessions.slots),
                avals=f"b{len(served)}",
                trace={"trace_ids": wave_trace_ids} if wave_trace_ids else None,
            ):
                if os.environ.get("ALPHATRIANGLE_FAULTS"):
                    from ..supervise.faults import fault_point

                    fault_point("serve-dispatch", self.dispatch_count)
                note_dispatch(serve_program_name(self.sessions.slots))
                out, reused, pre_states, host, pack = self._search_step(mask, key)
                if pack is not None:
                    fold = fold_search_stats(unpack_search_stats(pack))
                    if fold:
                        self._win_device_stats.append(fold)
            t1 = self._clock()
            self.last_output = out
            self.last_reused = reused
            actions_np = host[0].astype(np.int64)
            rewards_np, dones_np, scores_np = host[1], host[2] > 0, host[3]
            if self.emitter is not None:
                try:
                    self.emitter.on_dispatch(
                        pre_states, out, served, rewards_np, dones_np, self.weight_reloads
                    )
                except Exception:
                    logger.exception(
                        "trajectory emitter failed on dispatch %d; serving continues",
                        self.dispatch_count,
                    )

            batch_ms = (t1 - t0) * 1e3
            results = []
            for s in served:
                wait_ms = (t0 - s.pending_since) * 1e3
                lat_ms = (t1 - s.pending_since) * 1e3
                s.pending_since = None
                done = bool(dones_np[s.slot])
                if done and not s.done:
                    s.done = True
                    self.episodes_done_total += 1
                s.score = float(scores_np[s.slot])
                result = {
                    "sid": s.sid,
                    "slot": s.slot,
                    "move": s.moves,
                    "action": int(actions_np[s.slot]),
                    "reward": float(rewards_np[s.slot]),
                    "done": done,
                    "score": s.score,
                    "queue_wait_ms": wait_ms,
                    "latency_ms": lat_ms,
                }
                trace_id = self._session_trace.get(s.sid, {}).get("trace_id")
                if trace_id:
                    result["trace_id"] = trace_id
                results.append(result)
                self._win_wait_ms.append(wait_ms)
                self._win_lat_ms.append(lat_ms)
            self.dispatch_count += 1
            self.requests_total += len(results)
            self.simulations_total += self.sessions.slots * self.mcts.config.max_simulations
            if reused is not None:
                # Over the full slot array, as simulations_total.
                self.reused_visits_total += int(host[4].sum())
                # Only lanes this dispatch served and stepped, and whose
                # game goes on, may reuse their tree next time.
                self._carry_ok = mask & ~dones_np
            self.batch_ms.append(batch_ms)
            self._win_requests += len(results)
            self._win_batch_ms.append(batch_ms)
            fill = len(results) / self.sessions.slots
            self._win_fill.append(fill)
            self._ladder_fill.append(fill)
            # This dispatch ran at the old width; the next may run at the new.
            self._maybe_walk()
            if self.telemetry is not None:
                self.telemetry.on_rollout(
                    experiences=len(results), episodes=sum(1 for r in results if r["done"])
                )
            return results

    def serve_stats(self, drain: bool = True) -> dict:
        """The `serve_*` fields of one tick: occupancy and this window's
        request count, rate, fill and percentiles (the JAX service's
        keys, plus `serve_dispatches` and `serve_reused_visits_total`).
        `drain` starts a new
        window. Read and reset under the service lock, which a dispatch
        holds while it appends, so a drain loses no request."""
        with self._lock:
            now = self._clock()
            dt = max(1e-9, now - self._last_tick_t)
            snap = self.sessions.snapshot()
            stats = {
                "serve_slots": snap["slots"],
                "serve_bucket": snap["slots"],
                "serve_fill": round(float(self._win_fill[-1]), 4) if self._win_fill else None,
                "serve_rung_switches": self.rung_switches,
                "serve_sessions": snap["live"],
                "serve_sessions_admitted": snap["admitted_total"],
                "serve_sessions_retired": snap["retired_total"],
                "serve_queue_depth": self.queue_depth,
                "serve_requests_total": self.requests_total,
                "serve_dispatches": self.dispatch_count,
                "serve_window_requests": self._win_requests,
                "serve_requests_per_sec": round(self._win_requests / dt, 2),
                "serve_batch_fill": (
                    round(float(np.mean(self._win_fill)), 4) if self._win_fill else None
                ),
                "serve_batch_ms_p50": _pct(self._win_batch_ms, 0.50),
                "serve_batch_ms_p95": _pct(self._win_batch_ms, 0.95),
                "serve_queue_wait_ms_p50": _pct(self._win_wait_ms, 0.50),
                "serve_queue_wait_ms_p95": _pct(self._win_wait_ms, 0.95),
                "serve_move_latency_ms_p50": _pct(self._win_lat_ms, 0.50),
                "serve_move_latency_ms_p95": _pct(self._win_lat_ms, 0.95),
                "serve_weight_reloads": self.weight_reloads,
                "serve_reused_visits_total": self.reused_visits_total,
            }
            if drain:
                # This window's serve leg for `tick()` (None when stats are
                # off or no dispatch ran in the window).
                self._last_serve_ds = self.take_device_stats()
                self._win_wait_ms = []
                self._win_lat_ms = []
                self._win_batch_ms = []
                self._win_fill = []
                self._win_requests = 0
                self._last_tick_t = now
            return stats

    def take_device_stats(self) -> "dict | None":
        """The serve leg of the dispatches since the last take or drain
        (their folded stat-packs merged), and a new window; None when
        stats are off or no dispatch ran."""
        with self._lock:
            leg = merge_search_folds(self._win_device_stats)
            self._win_device_stats = []
            return leg

    def tick(self) -> "dict | None":
        """One telemetry tick: drain the window into a `kind: "util"`
        ledger record (the `serve_*` fields ride in it) and write the
        heartbeat. Returns the record; None without telemetry or on the
        meter's baseline tick."""
        if self.telemetry is None:
            return None
        stats = self.serve_stats(drain=True)
        extra = {k: v for k, v in stats.items() if v is not None}
        serve_ds = self._last_serve_ds
        if serve_ds:
            # The gauges ride the util record; the whole leg is its own
            # device_stats record below.
            if serve_ds.get("root_entropy") is not None:
                extra["root_visit_entropy"] = serve_ds["root_entropy"]
            if serve_ds.get("occupancy") is not None:
                extra["tree_occupancy"] = serve_ds["occupancy"]
            extra["beacons_armed"] = int(beacons_armed())
        record = self.telemetry.on_util_tick(
            step=self.dispatch_count,
            episodes=self.episodes_done_total,
            experiences=self.requests_total,
            simulations=self.simulations_total,
            reused_visits=self.reused_visits_total,
            buffer_size=self.queue_depth,
            dispatch_wall_s=getattr(self.flight, "sealed_wall_seconds", None),
            extra=extra,
        )
        if serve_ds:
            self.telemetry.record_device_stats(
                self.dispatch_count, serve=serve_ds, program=serve_program_name(self.sessions.slots)
            )
            self._last_serve_ds = None
        self.telemetry.on_tick(self.dispatch_count, buffer_size=self.queue_depth)
        return record


def build_serve_telemetry(
    run_dir, run_name: str, env_config, model_config, telemetry_config=None, device=None
):
    """A `RunTelemetry` for a serve run: heartbeat, watchdogs, ledger and
    flight ring, with a meter whose FLOPs are the serve path's (network
    forwards only). `device_kind` is the card's name, "cpu" on the CPU."""
    from ..device import resolve_device
    from ..telemetry import RunTelemetry
    from ..telemetry.perf import UtilizationMeter
    from ..utils.flops import forward_flops

    device = resolve_device(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    meter = UtilizationMeter(
        forward_flops=forward_flops(model_config, env_config, env_config.action_dim),
        train_step_flops=0,
        device_kind=kind,
        buffer_capacity=0,
    )
    return RunTelemetry(telemetry_config, run_dir=run_dir, run_name=run_name, perf=meter)
