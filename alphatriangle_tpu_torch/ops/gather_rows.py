"""Batched row gather: out[b, w, :] = stats[b, idx[b, w], :].

Counterpart of `alphatriangle_tpu/ops/gather_rows.py`. The MCTS descent
reads W tree rows per game per level. `gather_rows` dispatches by the
tensor's device: a CUDA tensor always goes through the hand-written
kernel (`csrc/gather_rows.cu`), a CPU tensor through the plain PyTorch
version. The mode knob keeps the JAX names ("einsum" | "pallas" |
"take") so a dumped JAX config loads; it never selects the plain
version on the card, and an unknown mode raises.
"""

import ctypes

import torch

from ._cuda import CudaKernel, check_cuda, stream_ptr

MODES = ("einsum", "pallas", "take")

KERNEL = CudaKernel(
    "gather_rows",
    "gather_rows.cu",
    "gather_rows_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
)


def gather_rows_plain(stats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, K), (B, W) -> (B, W, K) by advanced indexing."""
    bcol = torch.arange(stats.shape[0], device=stats.device)[:, None]
    return stats[bcol, idx.long()]


def gather_rows_cuda(stats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, K) f32, (B, W) int64 on the card -> (B, W, K) f32 through
    the kernel."""
    b, n, k = stats.shape
    idx = idx.to(torch.int64).contiguous()
    w = idx.shape[1]
    check_cuda("gather_rows stats", stats, torch.float32)
    check_cuda("gather_rows idx", idx, torch.int64, (b, w))
    if b * w >= 2**31:
        raise ValueError("gather_rows: B * W must fit in 31 bits")
    out = torch.empty((b, w, k), dtype=torch.float32, device=stats.device)
    vec = int(k % 4 == 0 and stats.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    KERNEL.launch(
        stats.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, w, k, vec, stream_ptr(stats)
    )
    return out


def gather_rows(stats: torch.Tensor, idx: torch.Tensor, mode: str = "einsum") -> torch.Tensor:
    """Dispatch by device: the kernel on CUDA, the plain version on CPU."""
    if mode not in MODES:
        raise ValueError(f"unknown gather mode: {mode!r}")
    if stats.device.type == "cuda":
        return gather_rows_cuda(stats, idx)
    if stats.device.type == "cpu":
        return gather_rows_plain(stats, idx)
    raise ValueError(f"gather_rows: unsupported device {stats.device}")
