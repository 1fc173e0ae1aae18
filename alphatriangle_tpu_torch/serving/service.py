"""Continuous-batching policy service over the lockstep wave search:
counterpart of `alphatriangle_tpu/serving/service.py` on a single rung.

Many concurrent game sessions multiplex onto ONE batched
`BatchedMCTS.search` over the full slot array. Requests queue between
dispatches; each dispatch serves every pending session with one search
and one masked step, then fetches its results to the host in one
transfer. `reload_weights` swaps the served net's weights between
dispatches.

With `MCTSConfig.tree_reuse` each lane carries its promoted search tree
across dispatches on the device: a dispatch searches from the carried
lanes the host still trusts (`_carry_ok`), then promotes the subtree of
the action the masked step plays. A lane's carry is cleared when its
session opens or closes, when its game ends, when it was not served
(its promotion was for a move it never played) and on every weight
reload (the carried statistics came from the old net).

Each served action is the search's own choice (`mcts.root_actions`):
the visit argmax, or a `GumbelMCTS`'s (usually `exploit=True`)
`selected_action`.

Under a reduced `INFERENCE_PRECISION` the search reads the net's
weights through `_serve_variables`: an `InferenceNet` (bf16, or int8
dequantized at each evaluation) cast once per (weights version, reload
count) and kept for the dispatches that follow, cast again after
`reload_weights` (`nn/precision.py`). Under float32 the search reads
the net's module itself.

The bucket ladder, telemetry, the flight recorder, the compile cache,
the trajectory emitter and the fault hooks wait for later slices.
"""

import threading
import time
from collections import deque

import numpy as np
import torch
from torch.profiler import record_function

from .. import rng
from ..mcts.search import CarriedTree
from ..nn import precision
from .session import SessionSlots


def _pct(values: list, q: float) -> "float | None":
    vals = sorted(values)
    if not vals:
        return None
    return float(vals[min(len(vals) - 1, max(0, round(q * (len(vals) - 1))))])


class PolicyService:
    """Request queue + micro-batcher over one `SessionSlots` array.

    Any thread may open/close sessions and enqueue move requests
    (lock-guarded); one caller drives `dispatch()` in a loop. Admission
    beyond the slot count raises: back-pressure belongs to the caller.
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
    ):
        self.env = env
        self.extractor = extractor
        self.net = net
        self.mcts = mcts
        self._clock = clock
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
        return self.sessions.slots

    # --- session lifecycle --------------------------------------------

    def open_session(self, reset_key: "torch.Tensor | None" = None, seed: "int | None" = None):
        """Admit one session (fresh game); raises when every slot is taken."""
        if reset_key is None:
            reset_key = rng.PRNGKey(0 if seed is None else seed)
        with self._lock:
            s = self.sessions.admit(reset_key)
            self._carry_ok[s.slot] = False
            return s

    def open_sessions(self, reset_keys: torch.Tensor) -> list:
        with self._lock:
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
            return results

    def serve_stats(self) -> dict:
        """Occupancy and per-dispatch wall-time percentiles."""
        snap = self.sessions.snapshot()
        return {
            "serve_slots": snap["slots"],
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
