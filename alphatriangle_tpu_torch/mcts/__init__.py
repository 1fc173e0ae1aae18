"""Batched wave-parallel search (PUCT or Gumbel root) and its helpers."""

from .helpers import (
    policy_target_from_visits,
    root_actions,
    select_action_from_visits,
    select_root_actions,
)
from .gumbel import GumbelMCTS
from .search import BatchedMCTS, SearchOutput, Tree

__all__ = [
    "BatchedMCTS",
    "GumbelMCTS",
    "SearchOutput",
    "Tree",
    "policy_target_from_visits",
    "root_actions",
    "select_action_from_visits",
    "select_root_actions",
]
