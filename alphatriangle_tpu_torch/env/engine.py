"""Batched triangle-puzzle engine on packed bitboards: counterpart of
`alphatriangle_tpu/env/engine.py`.

The (R, C) occupancy grid is packed into `NW = ceil(R*C/32)` words;
legality is a bitwise AND of the board against a precomputed
per-(shape, origin) footprint table whose impossible placements carry a
sentinel word that always collides; line clears are word masks plus a
population count. PyTorch has no uint32 shifts on the CPU and no
popcount op, so each word is an int64 holding a uint32 value and bits
are counted by SWAR.

Every function is batched over the leading dimension of its state. The
engine is deterministic per state: the hand refill draws from the
state's own key (`rng.py`, bit-exact with `jax.random`), so stepping
the same state with the same action twice gives the same child, which
the search relies on for duplicate edges.
"""

from dataclasses import dataclass, fields
from typing import NamedTuple

import numpy as np
import torch

from .. import rng
from ..config.env_config import EnvConfig
from ..device import resolve_device
from .geometry import EnvGeometry, build_geometry
from .shapes import ShapeBank, build_shape_bank

_M32 = 0xFFFFFFFF


@dataclass
class EnvState:
    """A batch of game states; every field has the same leading dims."""

    occupied: torch.Tensor  # (..., NW) int64 packed occupancy words
    color: torch.Tensor  # (..., R, C) int8; -1 where empty
    shape_idx: torch.Tensor  # (..., SLOTS) int32 into the bank; -1 = consumed
    shape_color: torch.Tensor  # (..., SLOTS) int8
    score: torch.Tensor  # (...) float32
    step_count: torch.Tensor  # (...) int32
    done: torch.Tensor  # (...) bool
    last_cleared: torch.Tensor  # (...) int32 triangles cleared by the last step
    key: torch.Tensor  # (..., 2) int64 key driving shape refills

    def map(self, fn) -> "EnvState":
        """Apply `fn` to every field."""
        return EnvState(**{f.name: fn(getattr(self, f.name)) for f in fields(self)})

    def replace(self, **kw) -> "EnvState":
        return EnvState(**{f.name: kw.get(f.name, getattr(self, f.name)) for f in fields(self)})


def where_state(mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per-lane select: `a` where `mask` (leading dims) holds, else `b`."""

    def pick(name):
        x, y = getattr(a, name), getattr(b, name)
        m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
        return torch.where(m, x, y)

    return EnvState(**{f.name: pick(f.name) for f in fields(EnvState)})


class _BitTables(NamedTuple):
    """Precomputed bitboard tables (NumPy, uint32)."""

    footprint_ext: np.ndarray  # (S, R*C, NW+1); word NW = blocked flag
    line_words: np.ndarray  # (L, NW)
    death_words: np.ndarray  # (NW,)
    cell_word: np.ndarray  # (R*C,) int32
    cell_bit: np.ndarray  # (R*C,) uint32


def _pack_np(grid: np.ndarray, nw: int) -> np.ndarray:
    """(R, C) bool -> (NW,) uint32."""
    flat = np.asarray(grid, dtype=bool).reshape(-1)
    words = np.zeros(nw, dtype=np.uint32)
    for cell in np.flatnonzero(flat):
        words[cell // 32] |= np.uint32(1) << np.uint32(cell % 32)
    return words


def _build_bit_tables(
    cfg: EnvConfig, bank: ShapeBank, geometry: EnvGeometry
) -> _BitTables:
    """A copy of `alphatriangle_tpu/env/engine.py::_build_bit_tables`."""
    rows, cols = cfg.ROWS, cfg.COLS
    cells = rows * cols
    nw = (cells + 31) // 32
    death_flat = geometry.death.reshape(-1)

    fp = np.zeros((bank.n_shapes, cells, nw + 1), dtype=np.uint32)
    for s in range(bank.n_shapes):
        for origin in range(cells):
            r, c = divmod(origin, cols)
            words = np.zeros(nw + 1, dtype=np.uint32)
            ok = True
            for t in range(bank.max_tris):
                if not bank.tri_valid[s, t]:
                    continue
                tr = r + int(bank.tri_r[s, t])
                tc = c + int(bank.tri_c[s, t])
                if not (0 <= tr < rows and 0 <= tc < cols):
                    ok = False
                    break
                # Parity: translation must preserve up/down-ness.
                if ((tr + tc) % 2 == 0) != bool(bank.tri_up[s, t]):
                    ok = False
                    break
                cell = tr * cols + tc
                if death_flat[cell]:
                    ok = False
                    break
                words[cell // 32] |= np.uint32(1) << np.uint32(cell % 32)
            if not ok:
                # Sentinel: word NW of the board is all-ones, so this
                # placement always collides.
                words[:] = 0
                words[nw] = 1
            fp[s, origin] = words

    line_words = (
        np.stack([_pack_np(m, nw) for m in geometry.line_masks])
        if geometry.n_lines
        else np.zeros((0, nw), np.uint32)
    )
    return _BitTables(
        footprint_ext=fp,
        line_words=line_words,
        death_words=_pack_np(geometry.death, nw),
        cell_word=(np.arange(cells) // 32).astype(np.int32),
        cell_bit=(np.arange(cells) % 32).astype(np.uint32),
    )


def _or_last(x: torch.Tensor) -> torch.Tensor:
    """Bitwise-OR over the (small, static) trailing word axis."""
    acc = x[..., 0]
    for w in range(1, x.shape[-1]):
        acc = acc | x[..., w]
    return acc


def _or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise-OR over any axis by pairwise halving."""
    x = x.movedim(dim, -1)
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    while x.shape[-1] > 1:
        n = x.shape[-1]
        half = n // 2
        head = x[..., :half] | x[..., half : 2 * half]
        x = torch.cat([head, x[..., 2 * half :]], dim=-1) if n % 2 else head
    return x[..., 0]


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint32 value held in an int64 (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


class TriangleEnv:
    """Static env: config, geometry and device-resident tables.

    Instances hold no game state; every function takes and returns
    `EnvState` batches owned by the caller.
    """

    def __init__(self, cfg: EnvConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bank: ShapeBank = build_shape_bank(cfg)
        self.geometry: EnvGeometry = build_geometry(cfg)
        self.rows, self.cols = cfg.ROWS, cfg.COLS
        self.num_slots = cfg.NUM_SHAPE_SLOTS
        self.action_dim = cfg.action_dim
        self.cells = self.rows * self.cols
        self.num_words = (self.cells + 31) // 32

        tables = _build_bit_tables(cfg, self.bank, self.geometry)
        # The host's copy: the native engine (env/native/) plays on these.
        self._tables_np = tables

        def dev(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a).astype(np.int64), device=self.device).to(dtype)

        self._fp_ext = dev(tables.footprint_ext)
        self._line_words = dev(tables.line_words)
        self._cell_word = dev(tables.cell_word)
        self._cell_bit = dev(tables.cell_bit)
        self._tri_r = dev(self.bank.tri_r)
        self._tri_c = dev(self.bank.tri_c)
        self._tri_valid = torch.as_tensor(self.bank.tri_valid, device=self.device)
        self._n_tris = dev(self.bank.n_tris)

    # --- bitboard helpers -------------------------------------------------

    def unpack_grid(self, words: torch.Tensor) -> torch.Tensor:
        """(..., NW) words -> (..., R, C) bool occupancy grid."""
        bits = (words[..., self._cell_word] >> self._cell_bit) & 1
        return (bits > 0).reshape(words.shape[:-1] + (self.rows, self.cols))

    def unpack_grid_np(self, words: np.ndarray) -> np.ndarray:
        """Host twin of `unpack_grid` for one game's (NW,) uint32 words."""
        t = self._tables_np
        bits = (np.asarray(words, dtype=np.uint32)[t.cell_word] >> t.cell_bit) & np.uint32(1)
        return (bits > 0).reshape(self.rows, self.cols)

    def _ones_word(self, lead: torch.Size) -> torch.Tensor:
        return torch.full(tuple(lead) + (1,), _M32, dtype=torch.int64, device=self.device)

    # --- transition functions (batched over the leading dim) ---------------

    def _legal_per_slot(self, occupied: torch.Tensor, shape_idx: torch.Tensor) -> torch.Tensor:
        """(B, SLOTS, R*C) bool legality of every origin for every slot."""
        fp = self._fp_ext[shape_idx.clamp(min=0).long()]  # (B, S, R*C, NW+1)
        occ_ext = torch.cat([occupied, self._ones_word(occupied.shape[:-1])], dim=-1)
        collide = _or_last(fp & occ_ext[:, None, None, :])
        return (collide == 0) & (shape_idx >= 0)[..., None]

    def valid_action_mask(self, state: EnvState) -> torch.Tensor:
        """(B, action_dim) bool; all-False rows where the game is over."""
        legal = self._legal_per_slot(state.occupied, state.shape_idx)
        return legal.reshape(legal.shape[0], -1) & ~state.done[:, None]

    def _any_placement(self, occupied: torch.Tensor, shape_idx: torch.Tensor) -> torch.Tensor:
        return self._legal_per_slot(occupied, shape_idx).flatten(1).any(dim=1)

    def _draw_hand(self, key: torch.Tensor):
        keys = rng.split(key)
        idx = rng.randint(keys[:, 0], (self.num_slots,), 0, self.bank.n_shapes)
        col = rng.randint(keys[:, 1], (self.num_slots,), 0, self.cfg.NUM_COLORS)
        return idx, col.to(torch.int8)

    def reset(self, keys: torch.Tensor) -> EnvState:
        """(B, 2) keys -> B fresh games."""
        keys = keys.to(self.device)
        batch = keys.shape[0]
        ks = rng.split(keys)
        shape_idx, shape_color = self._draw_hand(ks[:, 1])
        occupied = torch.zeros((batch, self.num_words), dtype=torch.int64, device=self.device)
        # A fresh board can still be unplayable on exotic configs.
        done = ~self._any_placement(occupied, shape_idx)
        return EnvState(
            occupied=occupied,
            color=torch.full(
                (batch, self.rows, self.cols), -1, dtype=torch.int8, device=self.device
            ),
            shape_idx=shape_idx,
            shape_color=shape_color,
            score=torch.zeros(batch, dtype=torch.float32, device=self.device),
            step_count=torch.zeros(batch, dtype=torch.int32, device=self.device),
            done=done,
            last_cleared=torch.zeros(batch, dtype=torch.int32, device=self.device),
            key=ks[:, 0],
        )

    def step(self, state: EnvState, action: torch.Tensor):
        """Apply one action per game. Returns (next_state, reward, done)."""
        cfg = self.cfg
        batch = action.shape[0]
        ar = torch.arange(batch, device=self.device)
        action = action.to(self.device).long()
        slot = action // self.cells
        origin = action % self.cells
        r = origin // self.cols
        c = origin % self.cols

        sidx_raw = state.shape_idx[ar, slot].long()
        sidx = sidx_raw.clamp(min=0)
        fp_ext = self._fp_ext[sidx, origin]  # (B, NW+1)
        occ_ext = torch.cat([state.occupied, self._ones_word((batch,))], dim=-1)
        collide = _or_last(fp_ext & occ_ext)
        valid = (collide == 0) & (sidx_raw >= 0) & ~state.done

        # --- place ---
        occ_placed = state.occupied | fp_ext[:, : self.num_words]
        n_placed = self._n_tris[sidx]
        # Color plane: scatter the shape's cells; padding and
        # out-of-board triangles land in a spare column that is dropped.
        tr = r[:, None] + self._tri_r[sidx]
        tc = c[:, None] + self._tri_c[sidx]
        on = self._tri_valid[sidx] & (tr < self.rows) & (tc < self.cols)
        flat = torch.where(on, tr * self.cols + tc, self.cells)
        color_ext = torch.cat(
            [
                state.color.reshape(batch, self.cells),
                torch.zeros((batch, 1), dtype=torch.int8, device=self.device),
            ],
            dim=1,
        )
        placed_color = state.shape_color[ar, slot][:, None].expand_as(flat)
        color_ext = color_ext.scatter(1, flat, placed_color)
        color_placed = color_ext[:, : self.cells].reshape(batch, self.rows, self.cols)

        # --- clear full lines ---
        lw = self._line_words
        miss = (occ_placed[:, None, :] & lw) ^ lw  # (B, L, NW)
        full = _or_last(miss) == 0  # (B, L)
        masked = torch.where(full[..., None], lw, torch.zeros_like(lw))
        cleared = _or_reduce(masked, dim=1)  # (B, NW)
        n_cleared = popcount32(cleared).sum(dim=-1).to(torch.int32)
        occ_next = occ_placed & ~cleared
        color_next = torch.where(
            self.unpack_grid(cleared), torch.tensor(-1, dtype=torch.int8, device=self.device),
            color_placed,
        )

        # --- consume slot; refill when the hand is empty ---
        hand = state.shape_idx.clone()
        hand[ar, slot] = -1
        all_empty = (hand < 0).all(dim=1)
        ks = rng.split(state.key)
        new_idx, new_col = self._draw_hand(ks[:, 1])
        hand = torch.where(all_empty[:, None], new_idx, hand)
        hand_colors = torch.where(all_empty[:, None], new_col, state.shape_color)

        # --- termination: no remaining shape fits ---
        stuck = ~self._any_placement(occ_next, hand)

        gain = (
            n_placed.to(torch.float32) * cfg.REWARD_PER_PLACED_TRIANGLE
            + n_cleared.to(torch.float32) * cfg.REWARD_PER_CLEARED_TRIANGLE
        )
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        penalty = torch.full((), cfg.PENALTY_GAME_OVER, dtype=torch.float32, device=self.device)
        reward_valid = gain + torch.where(stuck, penalty, zero)

        next_valid = EnvState(
            occupied=occ_next,
            color=color_next,
            shape_idx=hand,
            shape_color=hand_colors,
            score=state.score + gain,
            step_count=state.step_count + 1,
            done=stuck,
            last_cleared=n_cleared,
            key=ks[:, 0],
        )
        # Invalid action on a live game: forfeit (state frozen, game over).
        # Stepping a finished game is a no-op that keeps last_cleared.
        next_invalid = state.replace(
            done=torch.ones_like(state.done),
            last_cleared=torch.where(
                state.done, state.last_cleared, torch.zeros_like(state.last_cleared)
            ),
        )
        reward_invalid = torch.where(state.done, zero, penalty)
        next_state = where_state(valid, next_valid, next_invalid)
        reward = torch.where(valid, reward_valid, reward_invalid)
        return next_state, reward, next_state.done

    def reset_where_done(self, state: EnvState, key: torch.Tensor, lanes=None) -> EnvState:
        """Replace finished games with fresh ones; `key` is a single key,
        split over the whole lane array, of which `lanes` (a dp rank's
        `rng.Lanes`), when given, takes its rows."""
        batch = state.done.shape[0]
        fresh = self.reset(rng.split(key, batch, lanes=lanes))
        return where_state(state.done, fresh, state)
