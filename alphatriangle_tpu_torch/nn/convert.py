"""Flax variables -> the port's state dict.

`flax_to_torch(variables)` takes the JAX `NeuralNetwork.variables` as a
nested dict of numpy arrays (`{"params": {...}, "batch_stats": {...}}`)
and returns a state dict for `nn.model.AlphaTriangleNet`, whose
submodules carry the Flax names. Per leaf:

- Dense `kernel` (in, out) -> `weight` (out, in);
- Conv `kernel` HWIO -> `weight` OIHW;
- attention `query`/`key`/`value` `kernel` (D, H, hd) -> (H*hd, D) and
  `bias` (H, hd) -> (H*hd,); `out` `kernel` (H, hd, D) -> (D, H*hd);
- norm `scale`/`bias` -> `weight`/`bias`; BatchNorm `batch_stats`
  `mean`/`var` -> `running_mean`/`running_var`.
"""

from collections.abc import Mapping

import numpy as np
import torch

_ATTN_IN = ("query", "key", "value")


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict:
    out = {}
    for name, value in tree.items():
        path = prefix + (name,)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.array(value, dtype=np.float32)  # a writable copy
    return out


def _param_leaf(path: tuple, value: np.ndarray) -> tuple[str, np.ndarray]:
    *mods, leaf = path
    owner = mods[-1]
    parent = mods[-2] if len(mods) > 1 else ""
    if leaf == "scale":
        return "weight", value
    if leaf == "bias":
        if parent.startswith("MultiHeadDotProductAttention") and owner in _ATTN_IN:
            return "bias", value.reshape(-1)
        return "bias", value
    if leaf != "kernel":
        raise ValueError(f"unexpected Flax leaf {'/'.join(path)}")
    if parent.startswith("MultiHeadDotProductAttention"):
        if owner in _ATTN_IN:  # (D, H, hd)
            return "weight", value.reshape(value.shape[0], -1).T
        return "weight", value.reshape(-1, value.shape[-1]).T  # out: (H, hd, D)
    if value.ndim == 4:  # Conv HWIO -> OIHW
        return "weight", value.transpose(3, 2, 0, 1)
    return "weight", value.T  # Dense (in, out) -> (out, in)


def flax_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    """Nested numpy Flax variables -> `AlphaTriangleNet` state dict."""
    state = {}
    for path, value in _flatten(variables.get("params", {})).items():
        name, arr = _param_leaf(path, value)
        state[".".join(path[:-1] + (name,))] = torch.from_numpy(np.ascontiguousarray(arr))
    stats_names = {"mean": "running_mean", "var": "running_var"}
    for path, value in _flatten(variables.get("batch_stats", {})).items():
        name = stats_names[path[-1]]
        state[".".join(path[:-1] + (name,))] = torch.from_numpy(np.ascontiguousarray(value))
    return state
