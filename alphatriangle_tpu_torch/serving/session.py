"""Game-session slot array: counterpart of
`alphatriangle_tpu/serving/session.py` (`SessionSlots` admit, retire,
masked step, `migrate`, `host_results`).

A fixed array of B device-resident game slots; sessions are admitted
into the lowest free slots and retired out of them between dispatches,
so one search shape serves fluctuating load. Free slots hold frozen
`done=True` states: the engine steps them as no-ops and the search
evaluates them as terminal. Every per-lane quantity of the search
depends only on the lane's own state, its index and the dispatch key,
so a session plays the same game whatever the other lanes hold.
"""

import itertools
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import rng
from ..env.engine import where_state


@dataclass
class Session:
    """Host bookkeeping for one live (or just-retired) game session."""

    sid: int
    slot: int
    admitted_at: float
    moves: int = 0
    done: bool = False
    score: float = 0.0
    pending_since: "float | None" = None  # enqueue time of the open request

    def summary(self) -> dict:
        return {
            "sid": self.sid,
            "slot": self.slot,
            "moves": self.moves,
            "score": self.score,
            "done": self.done,
        }


class SessionSlots:
    """Fixed-shape slot array of concurrent game sessions on `env.device`."""

    def __init__(self, env, slots: int, pad_seed: int = 0):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.env = env
        self.slots = int(slots)
        self._free: list[int] = list(range(self.slots))
        self._by_slot: dict[int, Session] = {}
        self._sessions: dict[int, Session] = {}
        self._sid_counter = itertools.count(1)
        self.admitted_total = 0
        self.retired_total = 0
        base = env.reset(rng.split(rng.PRNGKey(pad_seed), self.slots))
        self.states = base.replace(done=torch.ones_like(base.done))

    # --- occupancy ----------------------------------------------------

    @property
    def live_count(self) -> int:
        return len(self._sessions)

    @property
    def free_count(self) -> int:
        return len(self._free)

    def live_sessions(self) -> list[Session]:
        return list(self._sessions.values())

    def session(self, sid: int) -> Session:
        return self._sessions[sid]

    # --- admit / retire (between dispatches only) ---------------------

    def admit_many(self, reset_keys: torch.Tensor) -> list[Session]:
        """Admit len(reset_keys) sessions into the lowest free slots;
        raises when the array is full."""
        n = int(reset_keys.shape[0])
        if n == 0:
            return []
        if n > len(self._free):
            raise RuntimeError(
                f"admit_many({n}): only {len(self._free)} of {self.slots} slots free"
            )
        self._free.sort()
        taken, self._free = self._free[:n], self._free[n:]
        fresh = self.env.reset(reset_keys)
        idx = torch.tensor(taken, dtype=torch.int64, device=self.env.device)
        for name in self.states.__dataclass_fields__:
            getattr(self.states, name)[idx] = getattr(fresh, name)
        now = time.monotonic()
        out = []
        for slot in taken:
            s = Session(sid=next(self._sid_counter), slot=slot, admitted_at=now)
            self._sessions[s.sid] = s
            self._by_slot[slot] = s
            out.append(s)
        self.admitted_total += n
        return out

    def admit(self, reset_key: torch.Tensor) -> Session:
        return self.admit_many(reset_key[None])[0]

    def retire(self, sid: int) -> dict:
        """Release a session's slot (re-frozen so the lane stays inert)
        and return its final summary (one host fetch)."""
        s = self._sessions.pop(sid)
        self._by_slot.pop(s.slot, None)
        st = self.states
        score, moves, done = torch.stack(
            [st.score[s.slot], st.step_count[s.slot].float(), st.done[s.slot].float()]
        ).tolist()
        s.score = float(score)
        s.moves = int(moves)
        s.done = bool(done)
        self.states.done[s.slot] = True
        self._free.append(s.slot)
        self.retired_total += 1
        return s.summary()

    # --- rung migration (the service's bucket ladder) ------------------

    def migrate(self, new_slots: int, pad_seed: int = 0) -> "SessionSlots":
        """A new array of `new_slots` lanes carrying every live session
        over: its pad lanes are those of a fresh `SessionSlots(env,
        new_slots, pad_seed)`, and the live sessions are re-packed
        lowest-old-slot-first into lanes 0..live-1, so relative lane
        order holds across any sequence of switches. Each state tensor
        moves in one index-select and one copy on the device. The same
        Session objects, sids, pending requests, admitted / retired
        totals and sid counter carry over (a migration is not an
        admission). Raises when the live sessions do not fit."""
        new_slots = int(new_slots)
        live = sorted(self._sessions.values(), key=lambda s: s.slot)
        if len(live) > new_slots:
            raise RuntimeError(f"migrate({new_slots}): {len(live)} live sessions do not fit")
        target = SessionSlots(self.env, new_slots, pad_seed=pad_seed)
        if live:
            old_idx = torch.tensor([s.slot for s in live], dtype=torch.int64, device=self.env.device)
            for name in self.states.__dataclass_fields__:
                getattr(target.states, name)[: len(live)] = getattr(self.states, name).index_select(
                    0, old_idx
                )
        target._sessions = self._sessions
        target._by_slot = {}
        target._free = list(range(len(live), new_slots))
        for i, s in enumerate(live):
            s.slot = i
            target._by_slot[i] = s
        target._sid_counter = self._sid_counter
        target.admitted_total = self.admitted_total
        target.retired_total = self.retired_total
        return target

    # --- the lockstep step --------------------------------------------

    def step(self, actions: torch.Tensor, mask):
        """Step lanes where `mask` holds; the rest keep their state bit
        for bit. Returns device (rewards, dones) for all lanes."""
        mask_np = np.asarray(mask, dtype=bool)
        dev = self.env.device
        mask_t = torch.from_numpy(mask_np).to(dev)
        stepped, rewards, dones = self.env.step(self.states, torch.as_tensor(actions, device=dev))
        self.states = where_state(mask_t, stepped, self.states)
        for s in self._sessions.values():
            if mask_np[s.slot]:
                s.moves += 1
        return rewards, dones

    # --- host views ----------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "slots": self.slots,
            "live": self.live_count,
            "free": self.free_count,
            "admitted_total": self.admitted_total,
            "retired_total": self.retired_total,
        }

    def host_results(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(scores, step_counts, done) for the whole array as NumPy."""
        st = self.states
        # graftlint: allow(host-sync-in-hot-path) one fetch of the whole slot array
        packed = torch.stack([st.score, st.step_count.float(), st.done.float()]).cpu().numpy()
        return packed[0], packed[1].astype(np.int32), packed[2].astype(bool)
