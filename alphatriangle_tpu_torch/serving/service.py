"""Continuous-batching policy service over the lockstep wave search:
counterpart of `alphatriangle_tpu/serving/service.py` on a single rung.

Many concurrent game sessions multiplex onto ONE batched
`BatchedMCTS.search` over the full slot array. Requests queue between
dispatches; each dispatch serves every pending session with one search
and one masked step, then fetches its results to the host in one
transfer. `reload_weights` swaps the served net's weights between
dispatches. The bucket ladder, subtree reuse, telemetry, the flight
recorder, the compile cache, the trajectory emitter and the fault
hooks wait for later slices.
"""

import threading
import time
from collections import deque

import numpy as np
import torch
from torch.profiler import record_function

from .. import rng
from ..mcts.helpers import root_actions
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
        precision = extractor.model_config.INFERENCE_PRECISION
        if precision != "float32":
            raise ValueError(
                f"INFERENCE_PRECISION={precision!r} is not ported yet; serve at 'float32'"
            )
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
        self.weight_reloads = 0
        self.batch_ms: list[float] = []  # per-dispatch wall time
        # The last dispatch's search output (device tensors, no fetch).
        self.last_output = None

    @property
    def max_slots(self) -> int:
        return self.sessions.slots

    # --- session lifecycle --------------------------------------------

    def open_session(self, reset_key: "torch.Tensor | None" = None, seed: "int | None" = None):
        """Admit one session (fresh game); raises when every slot is taken."""
        if reset_key is None:
            reset_key = rng.PRNGKey(0 if seed is None else seed)
        with self._lock:
            return self.sessions.admit(reset_key)

    def open_sessions(self, reset_keys: torch.Tensor) -> list:
        with self._lock:
            return self.sessions.admit_many(reset_keys)

    def close_session(self, sid: int) -> dict:
        with self._lock:
            s = self.sessions.session(sid)
            s.pending_since = None
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
        reload installed into the net externally). Returns the count."""
        with self._lock:
            if state_dict is not None:
                self.net.set_weights(state_dict)
            self.weight_reloads += 1
            return self.weight_reloads

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
            out = self.mcts.search(self.sessions.states, key)
            with record_function("serve.step"):
                actions = root_actions(out)
                rewards, dones = self.sessions.step(actions, mask)
            # The one host fetch of the dispatch: every result array.
            with record_function("serve.fetch"):
                host = torch.stack(
                    [
                        actions.to(torch.float32),
                        rewards,
                        dones.to(torch.float32),
                        self.sessions.states.score,
                    ]
                ).cpu().numpy()
            t1 = self._clock()
            self.last_output = out
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
        }
