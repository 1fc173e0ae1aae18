"""The sharding contract on `torch.distributed`: counterpart of
`alphatriangle_tpu/parallel/sharding.py` (`batch_sharding`,
`shard_batch`, `local_rows`, `_tp_spec`, `state_shardings`) over the
(dp, mdl, sp) mesh.

Data parallelism. The JAX learner shards its batch on dp and replicates
its state; GSPMD then inserts the gradient all-reduce. Here each rank
holds its own rows of every dp-sharded leading dimension (`batch_rows`:
the rank's contiguous range, dp-major, as a dp-sharded JAX array lays
its shards out) and a replica of the state. The replicas start equal
because rank 0's state is broadcast at setup and at a restore
(`broadcast_object`), and stay equal because every rank applies the
same all-reduced gradient (`all_reduce_mean_`, one flat bucket per step
over the dp line: the all-reduce's result is the same on every rank,
and so is the optimizer arithmetic on it). A batch norm takes its
statistics over the global batch (`synced_batch_stats`, an all-reduce
over the dp line whose backward all-reduces the gradient), as Flax's
`BatchNorm` does under GSPMD. Both reduce over the dp line, not the
world: an mdl or sp replica holds the same rows again.

Tensor parallelism (Megatron-LM, arXiv:1909.08053) over mdl, where JAX
lets GSPMD place the collectives from `_tp_spec`'s shardings:
`tp_spec` is `_tp_spec` on the port's parameter names and torch layouts
(q / k / v `(H*hd, D)` split on their rows, which are contiguous
`head_dim` blocks of whole heads; `out` `(D, H*hd)` on its columns; the
MLP's `Dense_0` `(mlp, D)` on its rows and `Dense_1` `(D, mlp)` on its
columns; a width that does not divide by mdl replicates its leaves).
`state_shardings` applies it to a state; `shard_tensor` / `gather_tensor`
move between a full tensor and a rank's shard (the Adam moments take the
parameters' layout, as optax state mirrors the params tree). The
Megatron pair, `copy_to_mdl` (f: identity forward, all-reduce of the
gradient backward, before a column-parallel matmul) and
`reduce_from_mdl` (g: all-reduce forward, identity backward, after a
row-parallel matmul), are the layer's only collectives; each runs under
the `tp.all_reduce` label, in float32.

Sequence parallelism over sp (`parallel/ring_attention.py`) cuts the
attention core only: `scatter_to_sp` takes this rank's slice of a
replicated tensor (its backward all-gathers the slices' gradients) and
`gather_from_sp` all-gathers the slices (its backward takes this rank's
slice), so every parameter's gradient comes out whole and equal on the
sp ranks, with no reduction over sp.

Collectives run on the group's tensors under NCCL. Under gloo every
collective on a card's tensor copies it to the host and back itself
(`_staged`: a synchronous copy each way, so no transfer of gloo's own
outlives the call): the dp gradient bucket, the batch norm's
statistics, the ring's max and the tensor- and sequence-parallel
collectives alike. Host scalars (`all_reduce_scalar`, `all_gather_ints`)
ride a CPU tensor under gloo and a CUDA one under NCCL, over the world:
they carry the decisions every rank must share. Python objects travel
over a line (`line_broadcast_object`, `line_gather_object`): the loop
shares a rollout's harvest over mdl and sp with them. With no process
group every helper is the identity, so a one-process run takes none of
these paths.
"""

import torch
import torch.distributed as dist

from ..config.mesh_config import Mesh, axis_ranks

ALL_REDUCE_LABEL = "dp.all_reduce"  # record_function label of the gradient bucket
TP_LABEL = "tp.all_reduce"  # record_function label of the Megatron pair's all-reduces
DP, MDL, SP = 0, 1, 2  # the mesh's axes, in its order
_ALONE = object()  # a line of this rank alone: no collective


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def line_group(mesh: Mesh, axis: int):
    """The process group of this rank's line along `axis` (DP, MDL, SP):
    None for the default group (the axis spans the world, a world of one
    included), `_ALONE` when the line is this rank alone or there is no
    process group."""
    if not _grouped():
        return _ALONE
    size = (mesh.dp, mesh.mdl, mesh.sp)[axis]
    if size == dist.get_world_size():
        return None
    if size == 1:
        return _ALONE
    if mesh.groups is None or mesh.axis_names[axis] not in mesh.groups:
        raise RuntimeError(
            f"mesh axis {mesh.axis_names[axis]!r} of {size} ranks has no process group: "
            "build the mesh through parallel.distributed.attach_groups"
        )
    return mesh.groups[mesh.axis_names[axis]]


def line_ranks(mesh: Mesh, axis: int) -> list:
    """The global ranks of this rank's line along `axis`, in axis order."""
    return axis_ranks(mesh, axis, (mesh.dp_index, mesh.mdl_index, mesh.sp_index))


def batch_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a dp-sharded leading dimension of length `n`
    (the mdl and sp ranks of a dp row hold the same rows)."""
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


def tp_spec(name: str, shape: tuple, mdl: int, heads: int) -> "int | None":
    """The dim of a transformer leaf (port name, torch layout) that
    splits over mdl, or None (replicated): `_tp_spec` of the JAX
    package on the converted names. q / k / v weights and biases and the
    `out` weight split on heads (all or none, as they share the head
    count); the MLP on its hidden width; every other leaf (the `out`
    and `Dense_1` biases, the norms, everything outside the transformer
    layers) is replicated."""
    if mdl <= 1 or "TransformerEncoderLayer" not in name:
        return None
    leaf = name.rsplit(".", 1)[-1]
    if ".MultiHeadDotProductAttention_0." in name:
        if heads % mdl:
            return None
        for proj in ("query", "key", "value"):
            if f".{proj}." in name and len(shape) == (2 if leaf == "weight" else 1):
                return 0
        if ".out." in name and leaf == "weight" and len(shape) == 2:
            return 1
        return None
    if ".Dense_0." in name:  # up-projection: column parallel
        if len(shape) == (2 if leaf == "weight" else 1):
            return 0 if shape[0] % mdl == 0 else None
    if ".Dense_1." in name and leaf == "weight" and len(shape) == 2:  # row parallel
        return 1 if shape[1] % mdl == 0 else None
    return None


def state_shardings(state: dict, mesh: Mesh, heads: int = 1) -> dict:
    """name -> "replicated", or the dim that splits over mdl
    (`tp_spec`), for every leaf of `state` (tensors or shapes by name)
    of a net with `heads` attention heads; all "replicated" at mdl = 1."""
    out = {}
    for name, leaf in state.items():
        shape = tuple(getattr(leaf, "shape", leaf if isinstance(leaf, tuple) else ()))
        dim = tp_spec(name, shape, mesh.mdl, heads)
        out[name] = "replicated" if dim is None else dim
    return out


def shard_tensor(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous mdl shard of a full tensor along `dim`."""
    return t.chunk(mesh.mdl, dim=dim)[mesh.mdl_index].contiguous()


def gather_tensor(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The full tensor of the mdl shards of `t` along `dim` (every mdl
    rank calls it)."""
    group = line_group(mesh, MDL)
    if group is _ALONE:
        return t
    return _all_gather_cat(t, dim, mesh.mdl, group)


def _staged(t: torch.Tensor, group) -> bool:
    """Does `t` travel through a host copy? Under gloo a card's tensor
    does: the collective then runs on CPU tensors and the result is
    copied back (a transport detail: the same bytes and arithmetic)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`t` reduced over `group` in place (`group` None: the world)."""
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over `group`, as a new tensor on t's device."""
    return _all_reduce_(t.clone(), group)


def _all_gather(t: torch.Tensor, n: int, group) -> list:
    """Every rank's `t` over `group` (n ranks), in rank order, on t's device."""
    src = t.cpu() if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return [part.to(t.device) for part in parts]


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`, reduced in float32, in x's dtype."""
    with torch.profiler.record_function(TP_LABEL):
        return _all_reduce_sum(x.float(), group).to(x.dtype)


class _SumOver(torch.autograd.Function):
    """The sum over a group, forward and backward (the all-reduce's
    transpose is itself)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_sum(grad.contiguous(), ctx.group), None


class _CopyToMdl(torch.autograd.Function):
    """Megatron's f: identity forward, gradient all-reduced over mdl."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_f32(grad, ctx.group), None


class _ReduceFromMdl(torch.autograd.Function):
    """Megatron's g: all-reduce over mdl forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_mdl(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """f before a column-parallel matmul: the replicated input, whose
    gradient (each rank's columns' share) is summed over mdl."""
    group = line_group(mesh, MDL)
    return x if group is _ALONE else _CopyToMdl.apply(x, group)


def reduce_from_mdl(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """g after a row-parallel matmul: the partial products summed over
    mdl (in float32); the gradient passes through whole."""
    group = line_group(mesh, MDL)
    return x if group is _ALONE else _ReduceFromMdl.apply(x, group)


class _ScatterToSp(torch.autograd.Function):
    """This rank's slice along `dim`; backward all-gathers the slices'
    gradients over sp."""

    @staticmethod
    def forward(ctx, x, dim, n, index, group):
        ctx.dim, ctx.n, ctx.group = dim, n, group
        return x.chunk(n, dim=dim)[index].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_cat(grad, ctx.dim, ctx.n, ctx.group), None, None, None, None


class _GatherFromSp(torch.autograd.Function):
    """The slices all-gathered along `dim`; backward takes this rank's."""

    @staticmethod
    def forward(ctx, x, dim, n, index, group):
        ctx.dim, ctx.n, ctx.index = dim, n, index
        return _all_gather_cat(x, dim, n, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, dim=ctx.dim)[ctx.index].contiguous(), None, None, None, None


def _all_gather_cat(x: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    return torch.cat(_all_gather(x, n, group), dim=dim)


def scatter_to_sp(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This sp rank's slice of a tensor replicated over sp."""
    group = line_group(mesh, SP)
    if group is _ALONE:
        return x
    return _ScatterToSp.apply(x, dim, mesh.sp, mesh.sp_index, group)


def gather_from_sp(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The sp ranks' slices of a tensor, whole on every sp rank."""
    group = line_group(mesh, SP)
    if group is _ALONE:
        return x
    return _GatherFromSp.apply(x, dim, mesh.sp, mesh.sp_index, group)


def all_reduce_sum_mdl(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`t` summed over this rank's mdl line (a new tensor; `t` itself
    without one)."""
    group = line_group(mesh, MDL)
    if group is _ALONE:
        return t
    return _all_reduce_sum(t, group)


def _scalar_device() -> torch.device:
    if _grouped() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


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
    """Average `tensors` over this rank's dp line in place, through one
    flat bucket; `extra` (a 1-D float32 tensor on the same device) rides
    the same bucket and comes back summed, not averaged."""
    group = line_group(mesh, DP)
    if group is _ALONE:
        return extra
    parts = [t.reshape(-1) for t in tensors]
    if extra is not None:
        parts.append(extra.to(parts[0].dtype))
    bucket = torch.cat(parts)
    with torch.profiler.record_function(ALL_REDUCE_LABEL):
        _all_reduce_(bucket, group)
    n = sum(t.numel() for t in tensors)
    flat = bucket[:n] / mesh.dp
    offset = 0
    for t in tensors:
        t.copy_(flat[offset: offset + t.numel()].view_as(t))
        offset += t.numel()
    return bucket[n:] if extra is not None else None


def line_broadcast_object(obj, mesh: Mesh, axis: int):
    """The picklable `obj` of the first rank of this rank's line along
    `axis`, on every rank of the line (every rank of the line calls it;
    the others' `obj` is ignored)."""
    group = line_group(mesh, axis)
    if group is _ALONE:
        return obj
    first = line_ranks(mesh, axis)[0]
    box = [obj if dist.get_rank() == first else None]
    dist.broadcast_object_list(box, first, group=group, device=_scalar_device())
    return box[0]


def line_gather_object(obj, mesh: Mesh, axis: int) -> list:
    """Every picklable `obj` of this rank's line along `axis`, in axis
    order."""
    group = line_group(mesh, axis)
    if group is _ALONE:
        return [obj]
    parts = [None] * (mesh.dp, mesh.mdl, mesh.sp)[axis]
    dist.all_gather_object(parts, obj, group=group)
    return parts


def all_reduce_max_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise max of `t` over the ranks, in place."""
    if _grouped():
        _all_reduce_(t, None, dist.ReduceOp.MAX)
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
    local means of x and x^2 (equal local batches) all-reduced over the
    dp line and averaged, var = E[x^2] - E[x]^2 clamped at 0, keepdim over `dims`.
    The all-reduce is differentiable (its backward all-reduces the
    gradient), so the learner's averaged gradient is the global batch's."""
    x = x.float()
    local = torch.stack([x.mean(dim=dims, keepdim=True), (x * x).mean(dim=dims, keepdim=True)])
    group = line_group(mesh, DP)
    total = local if group is _ALONE else _SumOver.apply(local, group) / mesh.dp
    mean = total[0]
    return mean, (total[1] - mean * mean).clamp(min=0.0)
