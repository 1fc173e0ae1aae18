"""Counter-based random streams: the port's counterpart of `jax.random`.

Bit-exact with JAX's default threefry2x32 PRNG under
`jax_threefry_partitionable=True` (the JAX 0.9 default; spec:
`jax/_src/prng.py` and `jax/_src/random.py`) for `PRNGKey`, `split`,
`fold_in`, `bits`, `randint` and `uniform`. The engine draws its hands
from these, so a game replays the JAX package's game move for move.

Keys are `(..., 2)` int64 tensors holding uint32 values: PyTorch has no
uint32 shifts on the CPU, so every word is an int64 masked to 32 bits.
A leading batch of keys draws a batch of independent streams (what
`jax.vmap` gives the JAX package).

`gumbel` and `gamma` are not bit-exact: `gumbel` takes logarithms that
differ from XLA's in the last bit, and `gamma` draws from a
`torch.Generator` seeded from the key instead of JAX's rejection
sampler. Tests that compare searches inject JAX's draws for both.

A single key on the CPU (the search and the service keep their key
schedule there) feeds its two words to device work as plain integers,
so no draw ever waits on the device.
"""

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) over broadcastable words.

    `k0`/`k1` are int64 tensors or Python ints holding uint32 values;
    returns the two output words as int64 tensors.
    """
    k2 = k0 ^ k1 ^ _KS_PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`: the seed's two 32-bit halves."""
    seed = int(seed) & ((1 << 64) - 1)
    return torch.tensor(
        [seed >> 32, seed & MASK32], dtype=torch.int64, device=device
    )


def _key_words(key: torch.Tensor, sample_ndim: int):
    """The key's two words, shaped to broadcast against a sample shape."""
    if key.shape[-1] != 2:
        raise ValueError(f"keys have a trailing dim of 2, got {tuple(key.shape)}")
    if key.dim() == 1 and key.device.type == "cpu":
        k0, k1 = key.tolist()
        return int(k0), int(k1)
    tail = (1,) * sample_ndim
    lead = tuple(key.shape[:-1])
    return key[..., 0].reshape(lead + tail), key[..., 1].reshape(lead + tail)


def _hash_counts(key: torch.Tensor, shape: tuple, device) -> tuple:
    """threefry(key, iota(shape)) with the 64-bit iota split hi/lo."""
    shape = tuple(int(s) for s in shape)
    k0, k1 = _key_words(key, len(shape))
    counts = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    counts = counts.reshape(shape)
    return threefry2x32(k0, k1, counts >> 32, counts & MASK32)


def _out_device(key: torch.Tensor, device):
    return key.device if device is None else torch.device(device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split`: (..., 2) keys -> (..., num, 2) keys."""
    y0, y1 = _hash_counts(key, (num,), key.device)
    y0, y1 = torch.broadcast_tensors(y0, y1)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: mix a uint32 `data` into (..., 2) keys."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK32
    else:
        data = torch.tensor(int(data) & MASK32, dtype=torch.int64, device=key.device)
    k0, k1 = _key_words(key, 0)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(data), data)
    y0, y1 = torch.broadcast_tensors(y0, y1)
    return torch.stack([y0, y1], dim=-1)


def bits(key: torch.Tensor, shape: tuple, device=None) -> torch.Tensor:
    """`jax.random.bits` (32-bit): (..., *shape) int64 words."""
    y0, y1 = _hash_counts(key, shape, _out_device(key, device))
    return y0 ^ y1


def randint(
    key: torch.Tensor, shape: tuple, minval: int, maxval: int, device=None
) -> torch.Tensor:
    """`jax.random.randint` (int32) over Python-int bounds."""
    minval, maxval = int(minval), int(maxval)
    keys = split(key)
    higher = bits(keys[..., 0, :], shape, device)
    lower = bits(keys[..., 1, :], shape, device)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    multiplier = (2**16 % span) ** 2 % span
    offset = ((higher % span) * multiplier) & MASK32
    offset = ((offset + lower % span) & MASK32) % span
    return (offset + minval).to(torch.int32)


def uniform(
    key: torch.Tensor,
    shape: tuple,
    minval: float = 0.0,
    maxval: float = 1.0,
    device=None,
) -> torch.Tensor:
    """`jax.random.uniform` (float32): 23 random mantissa bits in [1, 2),
    shifted and scaled onto [minval, maxval)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    b = bits(key, shape, device)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # XLA fuses the scale and shift into one multiply-add: one rounding,
    # which a float64 multiply-add reproduces for these 24-bit operands.
    out = (f.double() * float(hi - lo) + float(lo)).to(torch.float32)
    return torch.clamp(out, min=float(lo))


def gumbel(key: torch.Tensor, shape: tuple, device=None) -> torch.Tensor:
    """Standard Gumbel draws, `jax.random.gumbel`'s "low" mode:
    -log(-log(u)), u uniform on [tiny, 1)."""
    u = uniform(key, shape, minval=_F32_TINY, maxval=1.0, device=device)
    return -torch.log(-torch.log(u))


def gamma(key: torch.Tensor, alpha: float, shape: tuple, device=None) -> torch.Tensor:
    """Gamma(alpha, 1) draws from a generator seeded by the key.

    `key` is one key on the CPU. The draws follow the key but are not
    JAX's (see the module docstring)."""
    k0, k1 = (int(v) for v in key.tolist())
    dev = _out_device(key, device)
    gen = torch.Generator(device=dev)
    gen.manual_seed((k0 << 32) | k1)
    conc = torch.full(tuple(shape), float(alpha), dtype=torch.float32, device=dev)
    return torch._standard_gamma(conc, generator=gen)
