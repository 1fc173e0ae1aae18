"""Evaluation wrapper around `AlphaTriangleNet`: counterpart of
`alphatriangle_tpu/nn/network.py`.

The net holds its weights as one `LiveWeights` (version, module, ready
event), replaced whole: `set_weights` and `install` put a new module in
place and bump `weights_version`; they never write into the module that
is there. A rollout chunk reads `live` once at its start and searches
with that module to its end, as a JAX chunk reads `net.variables` once
when it is dispatched, so a sync from another thread never changes the
weights under a running chunk. On the card, `ready` is an event after
the copy that made the module: a chunk on another stream waits for it
before reading the module (`rl/self_play.py`).

`attention_fn` (`parallel/ring_attention.make_sp_attention`) is threaded
into the module's transformer, as the JAX net's: the parameters are the
same either way. Training setup builds self-play's net dense and gives
the learner's copy the sequence-parallel core (`rl/trainer.py`), whose
`sync_to_network` installs whole tensors in a dense module.

`evaluate_state` / `evaluate_batch` are the reference's single-state
surface (a policy dict and an expected value a `GameState`, with the
finiteness guards and the renormalization that falls back to uniform
over the valid actions). They run the installed module on the net's
device at the batch's own size: the JAX package pads a batch to a power
of two for XLA's shape cache, which changes none of its rows.

Callers that hold the module itself (a `BatchedMCTS` built on
`net.model`) pick up new weights by reading `net.model` again:
`PolicyService.reload_weights` does.

Beside the live weights the net keeps their inference copy
(`inference_model`, `nn/precision.py`): the live module itself under
float32; under bfloat16 or int8 one `InferenceNet` per installed
version, cast on the net's device on the first caller's stream, under a
lock so that two producer threads never cast one version twice. Every
engine of a loop shares the net, so every stream reads that one copy,
after waiting for its `ready` event.
"""

import copy
import logging
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..config.env_config import EnvConfig
from ..config.model_config import ModelConfig
from ..device import resolve_device
from ..utils.transfer import hand_off, receive
from . import precision
from .model import (
    AlphaTriangleNet,
    expected_value_from_logits,
    init_parameters,
    value_support,
)

logger = logging.getLogger(__name__)


class NetworkEvaluationError(Exception):
    """Raised when network evaluation produces unusable outputs."""


@dataclass(frozen=True)
class LiveWeights:
    """One installed set of weights: read whole, replaced whole."""

    version: int
    model: torch.nn.Module
    ready: "torch.cuda.Event | None" = None  # after the copy that made `model`


class NeuralNetwork:
    """Owns the model and its weights on `device`."""

    def __init__(
        self,
        model_config: ModelConfig,
        env_config: EnvConfig,
        seed: int = 0,
        state_dict: "dict | None" = None,
        device=None,
        attention_fn=None,
    ):
        self.device = resolve_device(device)
        self.model_config = model_config
        self.env_config = env_config
        self.action_dim = env_config.action_dim
        model = AlphaTriangleNet(
            model_config, self.action_dim, env_config.ROWS, env_config.COLS, attention_fn=attention_fn
        )
        init_parameters(model, seed)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.live = LiveWeights(0, model.to(self.device).eval().requires_grad_(False))
        self.support = value_support(model_config, self.device)
        self._cast: "tuple[int, precision.InferenceNet] | None" = None  # (version, copy)
        self._cast_lock = threading.Lock()

    @property
    def model(self) -> torch.nn.Module:
        return self.live.model

    @property
    def weights_version(self) -> int:
        return self.live.version

    def inference_model(self, live: "LiveWeights | None" = None):
        """The weights `live` (default: the installed ones) as the
        inference paths read them: the module under float32, else the
        version's memoized `InferenceNet` (its `ready` set after the
        cast)."""
        live = self.live if live is None else live
        if precision.inference_dtype(self.model_config) == torch.float32:
            return live.model
        with self._cast_lock:
            if self._cast is not None and self._cast[0] == live.version:
                return self._cast[1]
            receive([*live.model.parameters(), *live.model.buffers()], live.ready)
            cast = precision.InferenceNet(live.model, self.model_config)
            cast.ready = hand_off(self.device)
            self._cast = (live.version, cast)
            return cast

    def forget_inference_model(self) -> None:
        """Drop the memoized copy: the megastep trains the installed
        module in place without a new version, so a later chunk must
        cast it afresh."""
        with self._cast_lock:
            self._cast = None

    @torch.no_grad()
    def evaluate_features(self, grid: torch.Tensor, other: torch.Tensor, model=None):
        """(B,C,H,W) + (B,F) -> (policy_probs (B,A), values (B,)) on
        the net's device, from the installed module or `model` (an
        `inference_model()`, dequantized here when int8); raises on
        non-finite output."""
        model = self.model if model is None else model
        logits, value_logits = precision.apply(model, grid.to(self.device), other.to(self.device))
        probs = torch.softmax(logits, dim=-1)
        values = expected_value_from_logits(value_logits, self.support)
        if not bool(torch.isfinite(logits).all()):
            raise NetworkEvaluationError(f"Non-finite policy logits (shape {tuple(logits.shape)}).")
        if not (bool(torch.isfinite(probs).all()) and bool(torch.isfinite(values).all())):
            raise NetworkEvaluationError("Non-finite policy probs or values.")
        return probs, values

    # --- the single-state surface ----------------------------------------

    def _normalize_policy(self, probs: np.ndarray, state, label: str) -> np.ndarray:
        probs = np.maximum(probs, 0.0)
        total = float(probs.sum())
        if abs(total - 1.0) <= 1e-5:
            return probs
        if total > 1e-9:
            return probs / total
        valid = state.valid_actions()
        if not valid:
            raise NetworkEvaluationError(f"{label}: policy sum near zero with no valid actions.")
        logger.warning("%s: policy sum near zero; uniform over valid.", label)
        out = np.zeros_like(probs)
        out[np.asarray(valid)] = 1.0 / len(valid)
        return out

    def evaluate_state(self, state) -> tuple:
        """One `GameState` -> (the full {action: prob} mapping, expected value)."""
        from ..features.extractor import extract_state_features

        feats = extract_state_features(state, self.model_config)
        probs, values = self.evaluate_features(
            torch.from_numpy(feats["grid"][None]), torch.from_numpy(feats["other_features"][None])
        )
        p = self._normalize_policy(probs[0].cpu().numpy(), state, "evaluate_state")
        return {i: float(x) for i, x in enumerate(p)}, float(values[0])

    def evaluate_batch(self, states: list) -> list:
        """`GameState`s of one engine -> a (policy dict, value) each, from
        one forward over the stacked states."""
        if not states:
            return []
        from ..env.engine import EnvState
        from ..features.core import FeatureExtractor

        stacked = EnvState(**{
            name: torch.cat([getattr(s._state, name) for s in states])
            for name in EnvState.__dataclass_fields__
        })
        grids, others = FeatureExtractor(states[0]._env, self.model_config).extract(stacked)
        probs, values = self.evaluate_features(grids, others)
        probs, values = probs.cpu().numpy(), values.cpu().numpy()
        out = []
        for i, state in enumerate(states):
            p = self._normalize_policy(probs[i], state, f"evaluate_batch[{i}]")
            out.append(({a: float(x) for a, x in enumerate(p)}, float(values[i])))
        return out

    def get_weights(self) -> dict[str, torch.Tensor]:
        """The weights as a CPU state dict."""
        return {k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()}

    def install(self, model: torch.nn.Module) -> int:
        """Serve `model` (which the caller no longer writes) from now on,
        in eval mode without gradients; returns the bumped version. The
        copy that made it must be queued on the current stream."""
        model = model.eval().requires_grad_(False)
        self.live = LiveWeights(self.live.version + 1, model, hand_off(self.device))
        return self.live.version

    def set_weights(self, state_dict: dict) -> None:
        """Install a state dict in a fresh copy of the module; bumps
        `weights_version`."""
        model = copy.deepcopy(self.model)
        model.load_state_dict(state_dict)
        self.install(model)
