"""Visit-count post-processing: counterpart of
`alphatriangle_tpu/mcts/helpers.py` (`select_root_actions`,
`policy_target_from_visits`)."""

import numpy as np
import torch


def policy_target_from_visits(
    visit_counts: torch.Tensor, valid_mask: "torch.Tensor | None" = None
) -> torch.Tensor:
    """(..., A) visit counts -> normalised dense policy targets; rows
    with no visits fall back to uniform over valid (or all) actions."""
    counts = visit_counts.to(torch.float32)
    total = counts.sum(dim=-1, keepdim=True)
    fallback = torch.ones_like(counts) if valid_mask is None else valid_mask.to(torch.float32)
    fallback = fallback / fallback.sum(dim=-1, keepdim=True).clamp(min=1.0)
    return torch.where(total > 0, counts / total.clamp(min=1e-9), fallback)


def root_actions(output) -> torch.Tensor:
    """(B,) int64 exploitation actions on the search's device: the
    visit-count argmax (first maximum), 0 for rows with no visits
    (finished games, which the engine freezes)."""
    counts = output.visit_counts
    return torch.where(
        counts.sum(dim=-1) > 0, counts.argmax(dim=-1), torch.zeros_like(counts[:, 0], dtype=torch.int64)
    )


def select_root_actions(output) -> np.ndarray:
    """`root_actions` as NumPy (one host fetch)."""
    return root_actions(output).cpu().numpy()
