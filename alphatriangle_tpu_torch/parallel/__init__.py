"""Data parallelism on `torch.distributed` (counterpart of
`alphatriangle_tpu/parallel/`): process-group membership and the dp
sharding helpers. Ring and Ulysses attention (`ring_attention.py`) and
tensor-parallel layouts wait for ROADMAP.md item 6b."""

from .distributed import (
    DistributedConfig,
    initialize_distributed,
    is_primary,
    process_info,
    shutdown_distributed,
)
from .sharding import (
    all_reduce_mean_,
    batch_rows,
    broadcast_object,
    broadcast_tensors_,
    local_rows,
    shard_batch,
    state_shardings,
)

__all__ = [
    "DistributedConfig",
    "all_reduce_mean_",
    "batch_rows",
    "broadcast_object",
    "broadcast_tensors_",
    "initialize_distributed",
    "is_primary",
    "local_rows",
    "process_info",
    "shard_batch",
    "shutdown_distributed",
    "state_shardings",
]
