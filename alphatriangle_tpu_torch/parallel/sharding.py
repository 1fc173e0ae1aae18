"""The dp sharding contract on `torch.distributed`: counterpart of
`alphatriangle_tpu/parallel/sharding.py` (`batch_sharding`,
`shard_batch`, `local_rows`, `state_shardings`) at `mdl = 1`.

The JAX learner shards its batch on dp and replicates its state; GSPMD
then inserts the gradient all-reduce. Here each rank holds its own rows
of every dp-sharded leading dimension (`batch_rows`: the rank's
contiguous range, rank-major, as a dp-sharded JAX array lays its shards
out) and a replica of the state. The replicas start equal because rank
0's state is broadcast at setup and at a restore (`broadcast_tensors_`,
`broadcast_object`), and stay equal because every rank applies the
same all-reduced gradient (`all_reduce_mean_`, one flat bucket per
step: the all-reduce's result is the same on every rank, and so is the
optimizer arithmetic on it). A batch norm takes its statistics over the
global batch (`synced_batch_stats`, an all-reduce whose backward
all-reduces the gradient), as Flax's `BatchNorm` does under GSPMD.

Collectives run on the group's tensors: CUDA tensors under NCCL, and
under gloo whatever the rank's tensors are (gloo moves CUDA tensors
through host memory itself); host scalars (`all_reduce_scalar`,
`all_gather_ints`) ride a CPU tensor under gloo and a CUDA one under
NCCL. With no process group every helper is the identity, so a
one-process run takes none of these paths.
"""

import torch
import torch.distributed as dist
from torch.distributed import nn as dist_nn

from ..config.mesh_config import Mesh

ALL_REDUCE_LABEL = "dp.all_reduce"  # record_function label of the gradient bucket


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def batch_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a dp-sharded leading dimension of length `n`."""
    if n % mesh.dp:
        raise ValueError(f"leading dimension {n} does not divide over dp={mesh.dp}")
    per = n // mesh.dp
    return slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of every leaf of a global batch (dicts of numpy
    arrays or tensors), the inverse of concatenating the ranks' rows in
    rank order."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    return batch[batch_rows(batch.shape[0], mesh)]


def local_rows(arr, mesh: Mesh, axis: int = 0):
    """This rank's rows of an `axis`-sharded global array (1 for the
    stacked (K, B) outputs of fused steps)."""
    index = [slice(None)] * arr.ndim
    index[axis] = batch_rows(arr.shape[axis], mesh)
    return arr[tuple(index)]


def state_shardings(state: dict, mesh: Mesh) -> dict:
    """name -> "replicated" for every leaf: at mdl = 1 the learner's
    state is a replica on every rank (tensor-parallel layouts wait for
    ROADMAP.md item 6b; `MeshConfig.build_mesh` refuses MDL_SIZE > 1)."""
    return {name: "replicated" for name in state}


def _scalar_device() -> torch.device:
    if _grouped() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_tensors_(tensors, mesh: Mesh, src: int = 0) -> None:
    """Overwrite `tensors` in place with rank `src`'s values."""
    if not _grouped():
        return
    for t in tensors:
        dist.broadcast(t.data, src)


def _to_cpu(tree):
    if isinstance(tree, (dict, tuple, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {k: _to_cpu(v) for k, v in items}
        return out if isinstance(tree, dict) else type(tree)(out.values())
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def broadcast_object(obj, mesh: "Mesh | None" = None, src: int = 0):
    """Rank `src`'s picklable `obj` on every rank, its tensors moved to
    the CPU for the trip; `obj` itself without a group."""
    if not _grouped():
        return obj
    box = [_to_cpu(obj) if dist.get_rank() == src else None]
    dist.broadcast_object_list(box, src, device=_scalar_device())
    return box[0]


def all_reduce_mean_(tensors: list, mesh: Mesh, extra: "torch.Tensor | None" = None):
    """Average `tensors` over the ranks in place, through one flat
    bucket; `extra` (a 1-D float32 tensor on the same device) rides the
    same bucket and comes back summed, not averaged."""
    if not _grouped():
        return extra
    parts = [t.reshape(-1) for t in tensors]
    if extra is not None:
        parts.append(extra.to(parts[0].dtype))
    bucket = torch.cat(parts)
    with torch.profiler.record_function(ALL_REDUCE_LABEL):
        dist.all_reduce(bucket)
    n = sum(t.numel() for t in tensors)
    flat = bucket[:n] / mesh.dp
    offset = 0
    for t in tensors:
        t.copy_(flat[offset: offset + t.numel()].view_as(t))
        offset += t.numel()
    return bucket[n:] if extra is not None else None


def all_reduce_max_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise max of `t` over the ranks, in place."""
    if _grouped():
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def all_reduce_scalar(value: float, mesh: Mesh, op: str = "sum") -> float:
    """A host float reduced over the ranks ("sum", "max" or "min")."""
    if not _grouped():
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=_scalar_device())
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                           "min": dist.ReduceOp.MIN}[op])
    return float(t.item())


def all_gather_ints(values, mesh: Mesh) -> list:
    """Every rank's tuple of host ints, in rank order (one collective)."""
    values = [int(v) for v in values]
    if not _grouped():
        return [tuple(values)]
    t = torch.tensor(values, dtype=torch.int64, device=_scalar_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return [tuple(int(v) for v in o.tolist()) for o in out]


def synced_batch_stats(x: torch.Tensor, dims, mesh: Mesh) -> tuple:
    """Flax's fast-variance batch statistics over the GLOBAL batch: the
    local means of x and x^2 (equal local batches) all-reduced and
    averaged, var = E[x^2] - E[x]^2 clamped at 0, keepdim over `dims`.
    The all-reduce is differentiable (its backward all-reduces the
    gradient), so the learner's averaged gradient is the global batch's."""
    x = x.float()
    local = torch.stack([x.mean(dim=dims, keepdim=True), (x * x).mean(dim=dims, keepdim=True)])
    total = dist_nn.functional.all_reduce(local) / mesh.dp
    mean = total[0]
    return mean, (total[1] - mean * mean).clamp(min=0.0)
