"""Batch and experience types: counterpart of
`alphatriangle_tpu/utils/types.py`.

`DenseBatch` is the learner's fixed-shape batch; the host ring samples
it as NumPy arrays and the learner uploads it as tensors. `StateType`,
`Experience` and `dense_policy_from_mapping` are the per-sample tuple
form of the reference surface, which the host ring's `add` / `add_batch`
accept.
"""

from typing import TypedDict

import numpy as np
import torch


class StateType(TypedDict):
    """NN input for one game state."""

    grid: np.ndarray  # (C, H, W) float32; 1.0 occupied / 0.0 empty / -1.0 death
    other_features: np.ndarray  # (OTHER_NN_INPUT_FEATURES_DIM,) float32


# Sparse policy target {action: prob}.
PolicyTargetMapping = dict[int, float]

# (state, policy_target, n_step_return)
Experience = tuple[StateType, PolicyTargetMapping, float]


class DenseBatch(TypedDict):
    """Fixed-shape training batch: NumPy arrays from the host ring,
    tensors on the learner's device."""

    grid: torch.Tensor  # (B, C, H, W) float32
    other_features: torch.Tensor  # (B, F) float32
    policy_target: torch.Tensor  # (B, A) float32, rows sum to 1
    value_target: torch.Tensor  # (B,) float32 n-step returns
    weights: torch.Tensor  # (B,) float32 IS weights (ones if uniform)
    policy_weight: torch.Tensor  # (B,) float32 policy-loss mask


def dense_policy_from_mapping(mapping: PolicyTargetMapping, action_dim: int) -> np.ndarray:
    """Scatter a sparse {action: prob} mapping into a dense vector."""
    dense = np.zeros(action_dim, dtype=np.float32)
    for a, p in mapping.items():
        if 0 <= a < action_dim:
            dense[a] = p
    return dense
