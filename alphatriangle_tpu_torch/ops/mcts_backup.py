"""Fused MCTS edge-plane update: insertion + discounted backup, in place.

Counterpart of `alphatriangle_tpu/ops/mcts_backup.py`. `_wave` ends
every wave with W child insertions (`children` max, `e_reward` set with
the last write winning) and W x D visit/return adds along the recorded
descent paths, in the order levels ascending, members ascending within
a level. The port updates the four (B, N, A) planes in place (the JAX
op returns new arrays; here nothing else holds the old planes).

`backup_update` dispatches by device: a CUDA tensor always goes through
the hand-written kernel (`csrc/mcts_backup.cu`), a CPU tensor through
the plain PyTorch version. The mode knob keeps the JAX names ("xla" |
"pallas"); it never selects the plain version on the card, and an
unknown mode raises.

Shapes: planes (B, N, A) f32; `parents`/`actions` (B, W) int,
`new_child`/`rewards` (B, W) f32; `rec_node`/`rec_action` (B, W, D)
int, `rec_active` (B, W, D) bool, `returns` (B, W, D) f32.
"""

import ctypes

import torch

from ._cuda import CudaKernel, check_cuda, stream_ptr

MODES = ("xla", "pallas")
# Shared memory a launch gets without opting in to more.
_MAX_SHARED_BYTES = 48 * 1024

KERNEL = CudaKernel(
    "backup_update",
    "mcts_backup.cu",
    "backup_update_launch",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
)


def backup_update_plain(
    e_visits, e_value, children, e_reward,
    parents, actions, new_child, rewards,
    rec_node, rec_action, rec_active, returns,
):
    """The update as an explicit ordered loop of B-wide `index_put_`s,
    none of which repeats an index: insertions by member, then the
    backup by level, then member. Returns the four (updated) planes."""
    batch, w = parents.shape
    depth = rec_node.shape[-1]
    bcol = torch.arange(batch, device=e_visits.device)
    parents, actions = parents.long(), actions.long()
    for j in range(w):
        at = (bcol, parents[:, j], actions[:, j])
        children.index_put_(at, torch.maximum(children[at], new_child[:, j]))
        e_reward.index_put_(at, rewards[:, j])
    nd = rec_node.long().clamp(min=0)
    ac = rec_action.long().clamp(min=0)
    cnt = rec_active.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=e_visits.device)
    val = torch.where(rec_active, returns, zero)
    for lvl in range(depth):
        for j in range(w):
            at = (bcol, nd[:, j, lvl], ac[:, j, lvl])
            e_visits.index_put_(at, e_visits[at] + cnt[:, j, lvl])
            e_value.index_put_(at, e_value[at] + val[:, j, lvl])
    return e_visits, e_value, children, e_reward


def backup_update_cuda(
    e_visits, e_value, children, e_reward,
    parents, actions, new_child, rewards,
    rec_node, rec_action, rec_active, returns,
):
    """The update through the kernel, one block per game."""
    b, n, a = e_visits.shape
    w = parents.shape[1]
    d = rec_node.shape[-1]
    for name, plane in (
        ("e_visits", e_visits), ("e_value", e_value),
        ("children", children), ("e_reward", e_reward),
    ):
        check_cuda(f"backup_update {name}", plane, torch.float32, (b, n, a))
    parents = parents.to(torch.int64).contiguous()
    actions = actions.to(torch.int64).contiguous()
    new_child = new_child.to(torch.float32).contiguous()
    rewards = rewards.to(torch.float32).contiguous()
    rec_node = rec_node.to(torch.int64).contiguous()
    rec_action = rec_action.to(torch.int64).contiguous()
    rec_active = rec_active.to(torch.uint8).contiguous()
    returns = returns.to(torch.float32).contiguous()
    for name, t, dtype, shape in (
        ("parents", parents, torch.int64, (b, w)),
        ("actions", actions, torch.int64, (b, w)),
        ("new_child", new_child, torch.float32, (b, w)),
        ("rewards", rewards, torch.float32, (b, w)),
        ("rec_node", rec_node, torch.int64, (b, w, d)),
        ("rec_action", rec_action, torch.int64, (b, w, d)),
        ("rec_active", rec_active, torch.uint8, (b, w, d)),
        ("returns", returns, torch.float32, (b, w, d)),
    ):
        check_cuda(f"backup_update {name}", t, dtype, shape)
    if n * a >= 2**31:
        raise ValueError("backup_update: N * A must fit in 31 bits")
    if w * d * 12 + w * 4 > _MAX_SHARED_BYTES:  # backup_update_shared_bytes in the .cu
        raise ValueError(f"backup_update: W * D = {w * d} entries exceed the shared staging")
    KERNEL.launch(
        e_visits.data_ptr(), e_value.data_ptr(), children.data_ptr(), e_reward.data_ptr(),
        parents.data_ptr(), actions.data_ptr(), new_child.data_ptr(), rewards.data_ptr(),
        rec_node.data_ptr(), rec_action.data_ptr(), rec_active.data_ptr(), returns.data_ptr(),
        b, n, a, w, d, stream_ptr(e_visits),
    )
    return e_visits, e_value, children, e_reward


def backup_update(
    e_visits, e_value, children, e_reward,
    parents, actions, new_child, rewards,
    rec_node, rec_action, rec_active, returns,
    mode: str = "xla",
):
    """Dispatch by device; returns the four planes, updated in place
    (e_visits, e_value, children, e_reward)."""
    if mode not in MODES:
        raise ValueError(f"unknown backup mode: {mode!r}")
    args = (
        e_visits, e_value, children, e_reward, parents, actions, new_child, rewards,
        rec_node, rec_action, rec_active, returns,
    )
    if e_visits.device.type == "cuda":
        return backup_update_cuda(*args)
    if e_visits.device.type == "cpu":
        return backup_update_plain(*args)
    raise ValueError(f"backup_update: unsupported device {e_visits.device}")
