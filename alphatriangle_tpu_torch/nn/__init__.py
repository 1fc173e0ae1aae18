"""Policy/value network, its evaluation wrapper and the Flax converter."""

from .convert import flax_to_torch
from .model import AlphaTriangleNet, expected_value_from_logits, value_support
from .network import NetworkEvaluationError, NeuralNetwork

__all__ = [
    "AlphaTriangleNet",
    "NetworkEvaluationError",
    "NeuralNetwork",
    "expected_value_from_logits",
    "flax_to_torch",
    "value_support",
]
