"""Batch types: counterpart of the `DenseBatch` of
`alphatriangle_tpu/utils/types.py`, over tensors."""

from typing import TypedDict

import torch


class DenseBatch(TypedDict):
    """Fixed-shape training batch, on the learner's device."""

    grid: torch.Tensor  # (B, C, H, W) float32
    other_features: torch.Tensor  # (B, F) float32
    policy_target: torch.Tensor  # (B, A) float32, rows sum to 1
    value_target: torch.Tensor  # (B,) float32 n-step returns
    weights: torch.Tensor  # (B,) float32 IS weights (ones if uniform)
    policy_weight: torch.Tensor  # (B,) float32 policy-loss mask
