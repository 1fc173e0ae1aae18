"""One device-to-host copy for a whole tree of tensors.

`fetch(tree)` packs every tensor leaf of a nested dict/list/tuple into
one byte buffer on its device, copies that buffer to the host once, and
unpacks NumPy arrays of the leaves' dtypes and shapes. A megastep ends
with one such fetch instead of one blocking copy per output
(`alphatriangle_tpu/rl/megastep.py` fetches once with `jax.device_get`).
Non-tensor leaves pass through unchanged.
"""

import numpy as np
import torch


def _leaves(tree, out: list) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    if isinstance(tree, torch.Tensor):
        return next(it)
    return tree


def fetch(tree):
    """The tree with every tensor replaced by a NumPy array; one copy."""
    leaves: list[torch.Tensor] = []
    _leaves(tree, leaves)
    if not leaves:
        return tree
    parts = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in leaves]
    host = torch.cat(parts).cpu().numpy()
    arrays, offset = [], 0
    for t, part in zip(leaves, parts):
        n = part.numel()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        arrays.append(host[offset : offset + n].view(dtype).reshape(tuple(t.shape)).copy())
        offset += n
    return _rebuild(tree, iter(arrays))
