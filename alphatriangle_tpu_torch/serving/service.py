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

Telemetry, the flight recorder and the fault hooks wait for later
slices.
"""

import logging
import threading
import time
from collections import deque

import numpy as np
import torch
from torch.profiler import record_function

from .. import rng
from ..mcts.search import CarriedTree
from ..nn import precision
from .buckets import BucketLadder
from .session import SessionSlots

logger = logging.getLogger(__name__)

# The ladder's walk thresholds on the window's mean fill (the JAX
# service's defaults).
HIGH_WATER = 0.85
LOW_WATER = 0.25


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
    ):
        self.env = env
        self.extractor = extractor
        self.net = net
        self.mcts = mcts
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
        self._last_fill: "float | None" = None
        self._pad_seed = int(pad_seed)
        self.sessions = SessionSlots(env, slots, pad_seed=pad_seed)
        self._base_rng = rng.PRNGKey(rng_seed)
        self._lock = threading.RLock()
        self._queue: deque[int] = deque()  # sids with a pending request
        self.dispatch_count = 0
        self.requests_total = 0
        self.episodes_done_total = 0
        self.simulations_total = 0
        self.reused_visits_total = 0
        self.weight_reloads = 0
        self.batch_ms: list[float] = []  # per-dispatch wall time
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

    def close_session(self, sid: int) -> dict:
        with self._lock:
            s = self.sessions.session(sid)
            s.pending_since = None
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
            # The one host fetch of the dispatch: every result array.
            with record_function("serve.fetch"):
                rows = [
                    actions.to(torch.float32),
                    rewards,
                    dones.to(torch.float32),
                    self.sessions.states.score,
                ]
                if reused is not None:
                    rows.append(reused)
                host = torch.stack(rows).cpu().numpy()
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
                done = bool(dones_np[s.slot])
                if done and not s.done:
                    s.done = True
                    self.episodes_done_total += 1
                s.score = float(scores_np[s.slot])
                results.append(
                    {
                        "sid": s.sid,
                        "slot": s.slot,
                        "move": s.moves,
                        "action": int(actions_np[s.slot]),
                        "reward": float(rewards_np[s.slot]),
                        "done": done,
                        "score": s.score,
                        "queue_wait_ms": (t0 - s.pending_since) * 1e3,
                        "latency_ms": (t1 - s.pending_since) * 1e3,
                    }
                )
                s.pending_since = None
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
            fill = len(results) / self.sessions.slots
            self._last_fill = fill
            self._ladder_fill.append(fill)
            # This dispatch ran at the old width; the next may run at the new.
            self._maybe_walk()
            return results

    def serve_stats(self) -> dict:
        """Occupancy, the current rung and per-dispatch wall-time
        percentiles."""
        snap = self.sessions.snapshot()
        return {
            "serve_slots": snap["slots"],
            "serve_bucket": snap["slots"],
            "serve_fill": None if self._last_fill is None else round(self._last_fill, 4),
            "serve_rung_switches": self.rung_switches,
            "serve_sessions": snap["live"],
            "serve_sessions_admitted": snap["admitted_total"],
            "serve_sessions_retired": snap["retired_total"],
            "serve_queue_depth": self.queue_depth,
            "serve_requests_total": self.requests_total,
            "serve_dispatches": self.dispatch_count,
            "serve_batch_ms_p50": _pct(self.batch_ms, 0.50),
            "serve_batch_ms_p95": _pct(self.batch_ms, 0.95),
            "serve_weight_reloads": self.weight_reloads,
            "serve_reused_visits_total": self.reused_visits_total,
        }
