"""Stratified proportional PER draw: idx[s, j] ~ priorities / total.

Counterpart of `alphatriangle_tpu/ops/per_sample.py`. The megastep
samples its K learner batches on the card with an inclusive cumsum of
the priorities and a stratified count over it (`rl/megastep.py
_sample_indices`): stratum j of step row s draws uniformly from
[j/b * total, (j+1)/b * total), and the slot is the number of cumsum
entries below the draw, `#{i : cum[i] < u}`.

The cumsum, the stratum draws, the clip and the probabilities are torch
ops, as the JAX wrapper computes them outside Pallas. Only the count is
the kernel: `count_below` dispatches by the tensor's device. A CUDA
tensor always goes through the hand-written kernel
(`csrc/per_sample.cu`), a CPU tensor through `count_below_plain`. The
mode keeps the JAX names ("xla" | "pallas") so a dumped config loads;
it never selects the plain version on the card, and an unknown mode
raises.
"""

import ctypes

import torch

from .. import rng
from ._cuda import CudaKernel, check_cuda, stream_ptr

MODES = ("xla", "pallas")
# Elements of the (K, B, chunk) compare block the plain count holds at once.
_PLAIN_BLOCK = 1 << 24

# Elements of `cum` per tile summary (`kTile` in csrc/per_sample.cu).
TILE = 1024

KERNEL = CudaKernel(
    "per_sample",
    "per_sample.cu",
    "count_below_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
)


def count_below_plain(cum: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(n,), (k, b) -> (k, b) int32 `#{i : cum[i] < u}`, literally:
    every element compared with every draw, in chunks of `cum`."""
    n = cum.shape[0]
    out = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    chunk = max(1, _PLAIN_BLOCK // max(1, u.numel()))
    for lo in range(0, n, chunk):
        seg = cum[lo : lo + chunk]
        out += (seg < u[..., None]).sum(dim=-1, dtype=torch.int32)
    return out


def count_below_cuda(cum: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(n,) f32, (k, b) f32 on the card -> (k, b) int32 through the kernel:
    one summary per tile of `cum`, then one warp per draw (two grids, one
    launch of this op). Every output is written, so it is not zeroed."""
    check_cuda("per_sample cum", cum, torch.float32)
    check_cuda("per_sample u", u, torch.float32)
    if cum.dim() != 1:
        raise ValueError(f"per_sample: cum must be 1-D, got {tuple(cum.shape)}")
    n, q = cum.shape[0], u.numel()
    if n >= 2**31 or q >= 2**31:
        raise ValueError(f"per_sample: {n} priorities or {q} draws exceed 31-bit indices")
    out = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    # Tile summaries (min, max, count, pad), 16 bytes each: scratch.
    sums = torch.empty((-(-n // TILE), 4), dtype=torch.int32, device=u.device)
    KERNEL.launch(
        cum.data_ptr(), u.data_ptr(), out.data_ptr(), sums.data_ptr(), n, q, stream_ptr(cum)
    )
    return out


def count_below(cum: torch.Tensor, u: torch.Tensor, mode: str = "xla") -> torch.Tensor:
    """Dispatch by device: the kernel on CUDA, the plain count on CPU."""
    if mode not in MODES:
        raise ValueError(f"unknown PER sample mode: {mode!r}")
    if cum.device.type == "cuda":
        return count_below_cuda(cum.contiguous(), u.contiguous())
    if cum.device.type == "cpu":
        return count_below_plain(cum, u)
    raise ValueError(f"per_sample: unsupported device {cum.device}")


def stratum_draws(cum: torch.Tensor, k: int, b: int, key: torch.Tensor) -> torch.Tensor:
    """(k, b) f32 draws, `(arange(b) + uniform(key)) / b * total`, in the
    JAX wrapper's order of operations."""
    strata = torch.arange(b, dtype=torch.float32, device=cum.device)[None, :]
    return (strata + rng.uniform(key, (k, b), device=cum.device)) / b * cum[-1]


def per_sample(
    priorities: torch.Tensor,
    cap: int,
    k: int,
    b: int,
    key: torch.Tensor,
    mode: str = "xla",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stratified proportional draw of (k, b) slots from
    `priorities[:cap]`; returns (idx int64, probs f32). Zero-priority
    (empty or trash) slots have empty cumsum segments and are never
    drawn. `key` is one key on the CPU."""
    cum = torch.cumsum(priorities[:cap], dim=0)
    total = cum[-1]
    idx = count_below(cum, stratum_draws(cum, k, b, key), mode)
    idx = idx.clamp(0, cap - 1).long()
    probs = priorities[idx].clamp(min=1e-12) / total.clamp(min=1e-12)
    return idx, probs
