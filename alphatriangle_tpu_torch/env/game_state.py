"""One game with the reference's `GameState` API: counterpart of
`alphatriangle_tpu/env/game_state.py`.

Every transition goes through the port's batched `TriangleEnv` at a
batch of one, on an explicit device (the card unless the caller names
another; the tests pass `device="cpu"`), so host play and self-play
share one implementation of the rules. A seed's game is the JAX
package's game move for move: the reset and the refills draw from the
same threefry key (`rng.py`).

Not a hot path: self-play never touches this class. It serves `cli
play`, `NeuralNetwork.evaluate_state` / `evaluate_batch`, debugging and
tests.
"""

import json

import numpy as np
import torch

from .. import rng
from ..config.env_config import EnvConfig
from .engine import EnvState, TriangleEnv

# One engine per (EnvConfig, device): its tables live on the device.
_ENV_CACHE: dict = {}


def get_env(cfg: EnvConfig, device=None) -> TriangleEnv:
    """The cached engine of `cfg` on `device` (default the card)."""
    from ..device import resolve_device

    device = resolve_device(device)
    key = (json.dumps(cfg.model_dump(), sort_keys=True, default=str), str(device))
    env = _ENV_CACHE.get(key)
    if env is None:
        env = _ENV_CACHE[key] = TriangleEnv(cfg, device=device)
    return env


class Shape:
    """A placeable shape (the reference's `trianglengin.Shape` surface)."""

    def __init__(self, triangles: list, color_id: int = 0):
        self.triangles = triangles  # list of (r, c, is_up)
        self.color_id = color_id

    def bbox(self) -> tuple:
        """(min_r, min_c, max_r, max_c) over the shape's triangles."""
        rs = [t[0] for t in self.triangles]
        cs = [t[1] for t in self.triangles]
        return min(rs), min(cs), max(rs), max(cs)

    def __len__(self) -> int:
        return len(self.triangles)

    def __repr__(self) -> str:
        return f"Shape({len(self.triangles)} tris, color={self.color_id})"


class GameState:
    """One interactive game over the batched engine (a batch of one)."""

    def __init__(
        self,
        env_config: "EnvConfig | None" = None,
        initial_seed: int = 0,
        _state: "EnvState | None" = None,
        device=None,
    ):
        self.env_config = env_config or EnvConfig()
        self._env = get_env(self.env_config, device)
        if _state is not None:
            self._state = _state
        else:
            self._state = self._env.reset(rng.PRNGKey(initial_seed)[None])

    @property
    def device(self) -> torch.device:
        return self._env.device

    # --- queries ----------------------------------------------------------

    def is_over(self) -> bool:
        return bool(self._state.done[0])

    def get_game_over_reason(self) -> "str | None":
        if not self.is_over():
            return None
        return "no valid placement for any remaining shape"

    def valid_action_mask(self) -> np.ndarray:
        """(action_dim,) bool, the dense form."""
        return self._env.valid_action_mask(self._state)[0].cpu().numpy()

    def valid_actions(self) -> list:
        return [int(a) for a in np.flatnonzero(self.valid_action_mask())]

    def game_score(self) -> float:
        return float(self._state.score[0])

    @property
    def current_step(self) -> int:
        return int(self._state.step_count[0])

    def get_last_cleared_triangles(self) -> int:
        return int(self._state.last_cleared[0])

    def get_grid_data_np(self) -> dict:
        """Dense grid views (copies): occupied, death, color_id."""
        return {
            "occupied": self._env.unpack_grid(self._state.occupied)[0].cpu().numpy(),
            "death": self._env.geometry.death.copy(),
            "color_id": self._state.color[0].cpu().numpy(),
        }

    def get_shapes(self) -> list:
        """The hand; None for a consumed slot."""
        out: list = []
        bank = self._env.bank
        idx = self._state.shape_idx[0].tolist()
        colors = self._state.shape_color[0].tolist()
        for sidx, color in zip(idx, colors):
            if sidx < 0:
                out.append(None)
                continue
            tris = [(int(r), int(c), (int(r) + int(c)) % 2 == 0) for r, c in bank.shapes[sidx]]
            out.append(Shape(tris, color_id=int(color)))
        return out

    # --- transitions ------------------------------------------------------

    def step(self, action: int) -> tuple:
        """Apply `action`; returns (reward, done)."""
        state, reward, done = self._env.step(
            self._state, torch.tensor([int(action)], dtype=torch.int64)
        )
        self._state = state
        return float(reward[0]), bool(done[0])

    def copy(self) -> "GameState":
        return GameState(self.env_config, _state=self._state, device=self.device)

    def __repr__(self) -> str:
        return (
            f"GameState(step={self.current_step}, score={self.game_score():.1f}, "
            f"over={self.is_over()})"
        )
