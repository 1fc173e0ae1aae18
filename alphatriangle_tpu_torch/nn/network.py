"""Evaluation wrapper around `AlphaTriangleNet`: counterpart of
`alphatriangle_tpu/nn/network.py`.

The net is an `nn.Module` on one device, in eval mode; `set_weights`
installs a state dict in place (the search and the service hold the
same module, so they read new weights on their next call) and bumps
`weights_version`.
"""

import torch

from ..config.env_config import EnvConfig
from ..config.model_config import ModelConfig
from ..device import resolve_device
from .model import (
    AlphaTriangleNet,
    expected_value_from_logits,
    init_parameters,
    value_support,
)


class NetworkEvaluationError(Exception):
    """Raised when network evaluation produces unusable outputs."""


class NeuralNetwork:
    """Owns the model and its weights on `device`."""

    def __init__(
        self,
        model_config: ModelConfig,
        env_config: EnvConfig,
        seed: int = 0,
        state_dict: "dict | None" = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model_config = model_config
        self.env_config = env_config
        self.action_dim = env_config.action_dim
        model = AlphaTriangleNet(
            model_config, self.action_dim, env_config.ROWS, env_config.COLS
        )
        init_parameters(model, seed)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.support = value_support(model_config, self.device)
        self.weights_version = 0

    @torch.no_grad()
    def evaluate_features(self, grid: torch.Tensor, other: torch.Tensor):
        """(B,C,H,W) + (B,F) -> (policy_probs (B,A), values (B,)) on
        the net's device; raises on non-finite output."""
        logits, value_logits = self.model(grid.to(self.device), other.to(self.device))
        probs = torch.softmax(logits, dim=-1)
        values = expected_value_from_logits(value_logits, self.support)
        if not bool(torch.isfinite(logits).all()):
            raise NetworkEvaluationError(f"Non-finite policy logits (shape {tuple(logits.shape)}).")
        if not (bool(torch.isfinite(probs).all()) and bool(torch.isfinite(values).all())):
            raise NetworkEvaluationError("Non-finite policy probs or values.")
        return probs, values

    def get_weights(self) -> dict[str, torch.Tensor]:
        """The weights as a CPU state dict."""
        return {k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()}

    def set_weights(self, state_dict: dict) -> None:
        """Install a state dict in place; bumps `weights_version`."""
        self.model.load_state_dict(state_dict)
        self.weights_version += 1
