"""Grid scalar features: column heights, holes, bumpiness (batched).

Counterpart of `alphatriangle_tpu/features/grid_features.py`:
- ``height[c]`` = (index of the lowest occupied playable row in column
  c) + 1; 0 if empty.
- ``holes`` = number of empty playable cells with ``r < height[c]``.
- ``bumpiness`` = sum of |height[c] - height[c+1]| over adjacent columns.
"""

import torch


def column_heights(occupied: torch.Tensor, death: torch.Tensor) -> torch.Tensor:
    """(B, R, C) occupancy + (R, C) death -> (B, C) int32 column heights."""
    rows = occupied.shape[-2]
    playable_occ = occupied & ~death
    row_idx = torch.arange(1, rows + 1, dtype=torch.int32, device=occupied.device)[:, None]
    zero = torch.zeros((), dtype=torch.int32, device=occupied.device)
    return torch.where(playable_occ, row_idx, zero).amax(dim=-2)


def count_holes(
    occupied: torch.Tensor, death: torch.Tensor, heights: torch.Tensor
) -> torch.Tensor:
    """(B,) int32 count of empty playable cells below the height mark."""
    rows = occupied.shape[-2]
    row_idx = torch.arange(rows, dtype=torch.int32, device=occupied.device)[:, None]
    below = row_idx < heights[..., None, :]
    return (below & ~occupied & ~death).sum(dim=(-2, -1), dtype=torch.int32)


def bumpiness(heights: torch.Tensor) -> torch.Tensor:
    """(B,) float32 total absolute adjacent-column height difference."""
    return heights.diff(dim=-1).abs().sum(dim=-1).to(torch.float32)
