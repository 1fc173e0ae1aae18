"""Policy/value network, its evaluation wrapper and the Flax converter."""

from .convert import flax_inference_to_torch, flax_to_torch, train_state_from_flax
from .model import AlphaTriangleNet, expected_value_from_logits, value_support
from .network import NetworkEvaluationError, NeuralNetwork

__all__ = [
    "AlphaTriangleNet",
    "NetworkEvaluationError",
    "NeuralNetwork",
    "expected_value_from_logits",
    "flax_inference_to_torch",
    "flax_to_torch",
    "train_state_from_flax",
    "value_support",
]
