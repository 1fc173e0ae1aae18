"""Moving trees of arrays between the host, the card and its streams.

`fetch(tree)` packs every tensor leaf of a nested dict/list/tuple (or
dataclass) into
one byte buffer on its device, copies that buffer to the host once, and
unpacks NumPy arrays of the leaves' dtypes and shapes. A megastep ends
with one such fetch instead of one blocking copy per output
(`alphatriangle_tpu/rl/megastep.py` fetches once with `jax.device_get`).
Non-tensor leaves pass through unchanged. `upload(tree, device)` is the
other direction: NumPy leaves packed on the host, one copy to the
device, tensor views unpacked there (a learner batch, a host add).

`hand_off` and `receive` order a hand-over of device tensors between
threads that run on different CUDA streams: the sender records an event
on its stream after the work that made the tensors; the receiver's
stream waits for that event, and every tensor is marked as used on the
receiver's stream (`record_stream`), so the caching allocator does not
reuse its memory while work queued there may still read it. Both are
no-ops off CUDA.
"""

import dataclasses

import numpy as np
import torch


def _leaves(tree, kind, out: list) -> None:
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _leaves(getattr(tree, f.name), kind, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, kind, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, kind, out)
    elif isinstance(tree, kind):
        out.append(tree)


def _rebuild(tree, kind, it):
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: _rebuild(getattr(tree, f.name), kind, it) for f in dataclasses.fields(tree)}
        )
    if isinstance(tree, dict):
        return {k: _rebuild(v, kind, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, kind, it) for v in tree)
    if isinstance(tree, kind):
        return next(it)
    return tree


def fetch(tree):
    """The tree with every tensor replaced by a NumPy array; one copy."""
    leaves: list[torch.Tensor] = []
    _leaves(tree, torch.Tensor, leaves)
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
    return _rebuild(tree, torch.Tensor, iter(arrays))


_ALIGN = 16  # bytes: every unpacked view starts aligned for its dtype


def upload(tree, device):
    """The tree with every NumPy leaf replaced by a tensor on `device`;
    one host-to-device copy."""
    leaves: list[np.ndarray] = []
    _leaves(tree, np.ndarray, leaves)
    arrays = [np.ascontiguousarray(a) for a in leaves]
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // _ALIGN) * _ALIGN
    host = np.zeros(total, np.uint8)
    for a, off in zip(arrays, offsets):
        host[off : off + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = torch.from_numpy(host).to(device)
    tensors = [
        buf[off : off + a.nbytes].view(torch.from_numpy(a[:0].reshape(-1)).dtype).reshape(a.shape)
        for a, off in zip(arrays, offsets)
    ]
    return _rebuild(tree, np.ndarray, iter(tensors))


def hand_off(device) -> "torch.cuda.Event | None":
    """An event on `device`'s current stream after the work queued on it
    so far, for a `receive` on another stream (None off CUDA)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def receive(tree, ready: "torch.cuda.Event | None") -> None:
    """Take the tensors of `tree` over onto this thread's current stream:
    wait for `ready` (from `hand_off`), and mark every CUDA tensor leaf as
    used on this stream."""
    leaves: list[torch.Tensor] = []
    _leaves(tree, torch.Tensor, leaves)
    leaves = [t for t in leaves if t.is_cuda]
    if not leaves:
        return
    stream = torch.cuda.current_stream(leaves[0].device)
    if ready is not None:
        stream.wait_event(ready)
    for t in leaves:
        t.record_stream(stream)
