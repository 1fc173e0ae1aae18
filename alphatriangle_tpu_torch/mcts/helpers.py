"""Root-action and policy-target helpers: counterpart of
`alphatriangle_tpu/mcts/helpers.py` (`select_root_actions`,
`policy_target_from_visits`, `select_action_from_visits`)."""

import numpy as np
import torch

from .. import rng


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


def root_actions(output, use_gumbel: bool = False) -> torch.Tensor:
    """(B,) int64 exploitation actions on the search's device. PUCT: the
    visit-count argmax (first maximum), 0 for rows with no visits
    (finished games, which the engine freezes). Gumbel: the search's
    own `selected_action`, its -1 sentinel clamped to 0. The one action
    rule of serving, the arena and `cli eval`."""
    if use_gumbel:
        return output.selected_action.clamp(min=0).to(torch.int64)
    counts = output.visit_counts
    return torch.where(
        counts.sum(dim=-1) > 0, counts.argmax(dim=-1), torch.zeros_like(counts[:, 0], dtype=torch.int64)
    )


def select_root_actions(output, use_gumbel: bool = False) -> np.ndarray:
    """`root_actions` as NumPy (one host fetch)."""
    return root_actions(output, use_gumbel).cpu().numpy()


def select_action_from_visits(
    visit_counts: torch.Tensor, temperature, key: torch.Tensor, lanes: "rng.Lanes | None" = None
) -> torch.Tensor:
    """(B, A) visit counts -> (B,) int32 sampled actions.

    T <= 1e-8 plays the greedy argmax (first maximum); T > 0 samples
    proportionally to counts^(1/T) as the Gumbel-argmax of
    log(counts) / T. Zero-count actions are never chosen, and a row
    with no visits gives the sentinel -1 (callers clamp it: finished
    games). `temperature` is a float or a (B,) tensor; `key` is one key
    on the CPU, drawn through `rng.gumbel` (a dp rank's rows of the
    whole lane array's draw when `lanes` is given).
    """
    counts = visit_counts.to(torch.float32)
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=counts.device)
    temp = temp.expand(counts.shape[:-1])[..., None]
    log_counts = torch.where(counts > 0, torch.log(counts), float("-inf"))
    greedy = torch.argmax(log_counts, dim=-1)
    gumbel = rng.gumbel(key, tuple(counts.shape), device=counts.device, lanes=lanes)
    sampled = torch.argmax(log_counts / temp.clamp(min=1e-6) + gumbel, dim=-1)
    chosen = torch.where(temp[..., 0] <= 1e-8, greedy, sampled)
    any_visits = counts.sum(dim=-1) > 0
    return torch.where(any_visits, chosen, -1).to(torch.int32)
