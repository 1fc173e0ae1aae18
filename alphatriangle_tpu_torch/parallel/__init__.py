"""The (dp, mdl, sp) mesh on `torch.distributed` (counterpart of
`alphatriangle_tpu/parallel/`): process-group membership and the axes'
groups (`distributed.py`), the dp and tensor-parallel sharding helpers
(`sharding.py`) and ring and Ulysses attention (`ring_attention.py`)."""

from .distributed import (
    DistributedConfig,
    attach_groups,
    initialize_distributed,
    is_primary,
    process_info,
    shutdown_distributed,
)
from .ring_attention import make_sp_attention, ring_attention, ulysses_attention
from .sharding import (
    all_reduce_mean_,
    batch_rows,
    broadcast_object,
    local_rows,
    shard_batch,
    state_shardings,
    tp_spec,
)

__all__ = [
    "DistributedConfig",
    "all_reduce_mean_",
    "attach_groups",
    "batch_rows",
    "broadcast_object",
    "initialize_distributed",
    "is_primary",
    "local_rows",
    "make_sp_attention",
    "process_info",
    "ring_attention",
    "shard_batch",
    "shutdown_distributed",
    "state_shardings",
    "tp_spec",
    "ulysses_attention",
]
