"""Batched wave-parallel PUCT search and its visit-count helpers."""

from .helpers import (
    policy_target_from_visits,
    root_actions,
    select_action_from_visits,
    select_root_actions,
)
from .search import BatchedMCTS, SearchOutput, Tree

__all__ = [
    "BatchedMCTS",
    "SearchOutput",
    "Tree",
    "policy_target_from_visits",
    "root_actions",
    "select_action_from_visits",
    "select_root_actions",
]
