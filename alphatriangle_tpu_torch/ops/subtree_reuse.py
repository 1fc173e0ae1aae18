"""Static-shape MCTS root promotion: subtree reuse across moves.

Counterpart of `alphatriangle_tpu/ops/subtree_reuse.py`. After a move
plays action `a`, the chosen child `c0 = children[b, 0, a]` roots the
subtree worth keeping. Promotion relabels the fixed (B, N, A) edge
planes so that subtree fills the leading rows in BFS order:

1. The plan (`promotion_plan`, torch ops): `bfs_rounds` rounds of
   scatter-min relaxation over the `children` forest give each node its
   BFS depth from `c0`; a stable argsort of `depth * N + node_id` is the
   BFS order (rank 0 is `c0`, parents rank before their children); its
   inverse remaps child pointers; ranks past `max_retained` are dropped
   and their parent edges revert to unexpanded (-1).
2. The row reorder of the six f32 planes, freed rows zeroed (children
   rows -1): on a CUDA tensor the hand-written kernel
   (`csrc/subtree_promote.cu`), on a CPU tensor the plain gather and
   `where` of `reorder_planes_plain`. The mode knob
   (`MCTSConfig.tree_reuse_backend`) keeps the JAX names ("xla" |
   "pallas") so a dumped JAX config loads; it never selects the plain
   version on the card, and an unknown mode raises.

`subtree_promote` returns the planes and `terminal` in the new layout,
`state_index` (B, N) int64 (the old row each `node_state` row is
gathered from; freed rows point at `c0`), `promo_valid` (B,) bool (False
where the chosen child was never expanded) and `retained` (B,) int32
(the rows kept: the next search's insertion base).
"""

import ctypes

import torch

from ._cuda import CudaKernel, check_cuda, stream_ptr

MODES = ("xla", "pallas")
FILLS = (0.0, 0.0, 0.0, -1.0, 0.0, 0.0)  # visits, value, reward, children, prior, valid

KERNEL = CudaKernel(
    "subtree_promote",
    "subtree_promote.cu",
    "subtree_promote_launch",
    [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)


def promotion_plan(
    children: torch.Tensor, actions: torch.Tensor, max_retained: int, bfs_rounds: int
):
    """BFS-rank compaction plan over the `children` forest.

    Returns `(order, state_index, keep_mask, new_children, promo_valid,
    retained)`: `order[b, r]` is the old row at BFS rank r (int64),
    `keep_mask[b, r]` whether output row r is live (`r < retained[b]`),
    `new_children` the children plane remapped to new ids in the OLD
    row layout (the reorder then moves its rows)."""
    b, n, a = children.shape
    dev = children.device
    barange = torch.arange(b, device=dev)
    node_ids = torch.arange(n, device=dev)[None, :]

    c0 = children[barange, 0, actions.long()].to(torch.int32)  # (B,)
    promo_valid = c0 >= 0
    c0c = c0.clamp(min=0).long()

    child_ids = children.to(torch.int32)  # -1 = none
    has_child = child_ids >= 0
    # The (B, N*A) scatter index, built once for every round. A missing
    # child scatters the no-op `n` (min with any depth), so its target is
    # free: spreading those targets over the lane's rows, where the JAX
    # package sends them all to row 0, spares the card's atomics from
    # contending for one address per lane.
    spread = (torch.arange(n * a, device=dev) % n).reshape(1, n, a)
    tgt = torch.where(has_child, child_ids, spread).reshape(b, n * a).long()

    # BFS depth from c0 by scatter-min relaxation; `n` is the unreached
    # sentinel. Invalid lanes seed nothing and retain nothing. Each edge
    # offers its parent's depth + 1 and a missing child offers more than
    # `n`: offers of `n` or more leave the min as it was, so an unreached
    # parent's edges, as the JAX package's masked `n`, change nothing.
    big = n
    depth = torch.full((b, n), big, dtype=torch.int32, device=dev)
    depth[barange, c0c] = torch.where(promo_valid, 0, big).to(torch.int32)
    step = torch.where(has_child, 1, big + 1).to(torch.int32)
    for _ in range(bfs_rounds):
        cand = (depth[:, :, None] + step).reshape(b, n * a)
        depth = depth.scatter_reduce(1, tgt, cand, reduce="amin", include_self=True)

    reached = depth < big
    # Depth-major, old id minor; unreached rows share the key n*n, so the
    # sort must be stable to order them as the JAX package does.
    key = torch.where(reached, depth * n + node_ids, n * n)
    order = torch.argsort(key, dim=1, stable=True)  # (B, N) int64
    rank = torch.zeros((b, n), dtype=torch.int64, device=dev)
    rank.scatter_(1, order, node_ids.expand(b, n).contiguous())
    retained = torch.where(
        promo_valid, reached.sum(dim=1).clamp(max=max_retained), 0
    ).to(torch.int32)
    keep_old = reached & (rank < max_retained) & promo_valid[:, None]

    # Child pointers remapped to new ids; edges to dropped children
    # revert to unexpanded (-1) but keep their statistics.
    keep_c = keep_old.gather(1, tgt).reshape(b, n, a) & has_child
    new_children = torch.where(
        keep_c, rank.gather(1, tgt).reshape(b, n, a).to(torch.float32), -1.0
    )

    keep_mask = node_ids < retained[:, None]  # over NEW rows
    state_index = torch.where(keep_mask, order, c0c[:, None])
    return order, state_index, keep_mask, new_children, promo_valid, retained


def reorder_planes_plain(order: torch.Tensor, keep_mask: torch.Tensor, planes) -> tuple:
    """out[b, r] = plane[b, order[b, r]] where kept, else the fill."""
    a = planes[0].shape[-1]
    idx = torch.where(keep_mask, order, 0)[:, :, None].expand(-1, -1, a)
    keep = keep_mask[:, :, None]
    return tuple(
        torch.where(keep, plane.gather(1, idx), fill) for plane, fill in zip(planes, FILLS)
    )


def reorder_planes_cuda(order: torch.Tensor, retained: torch.Tensor, planes) -> tuple:
    """The six-plane reorder through the kernel, one block per output
    row; `order` (B, N) int64, `retained` (B,) int32."""
    b, n, a = planes[0].shape
    for q, plane in enumerate(planes):
        check_cuda(f"subtree_promote plane {q}", plane, torch.float32, (b, n, a))
    order = order.to(torch.int64).contiguous()
    retained = retained.to(torch.int32).contiguous()
    check_cuda("subtree_promote order", order, torch.int64, (b, n))
    check_cuda("subtree_promote retained", retained, torch.int32, (b,))
    if b * n >= 2**31:
        raise ValueError("subtree_promote: B * N must fit in 31 bits")
    outs = tuple(torch.empty_like(plane) for plane in planes)
    ptrs = [t.data_ptr() for t in (*planes, *outs)]
    vec = int(a % 4 == 0 and all(p % 16 == 0 for p in ptrs))
    KERNEL.launch(
        order.data_ptr(), retained.data_ptr(), *ptrs, b, n, a, vec, stream_ptr(order)
    )
    return outs


def subtree_promote(
    e_visits, e_value, e_reward, children, prior, valid, terminal, actions,
    max_retained: int, bfs_rounds: int, mode: str = "xla",
) -> tuple:
    """Promote each game's chosen child to the root row (module doc).

    Returns `(e_visits, e_value, e_reward, children, prior, valid,
    terminal, state_index, promo_valid, retained)`."""
    if mode not in MODES:
        raise ValueError(f"unknown subtree_promote mode: {mode!r}")
    order, state_index, keep_mask, new_children, promo_valid, retained = promotion_plan(
        children, actions, max_retained, bfs_rounds
    )
    planes = (e_visits, e_value, e_reward, new_children, prior, valid)
    if e_visits.device.type == "cuda":
        out = reorder_planes_cuda(order, retained, planes)
    elif e_visits.device.type == "cpu":
        out = reorder_planes_plain(order, keep_mask, planes)
    else:
        raise ValueError(f"subtree_promote: unsupported device {e_visits.device}")
    # terminal is bool: the same gather epilogue on every device.
    term = keep_mask & terminal.gather(1, torch.where(keep_mask, order, 0))
    return out + (term, state_index, promo_valid, retained)
