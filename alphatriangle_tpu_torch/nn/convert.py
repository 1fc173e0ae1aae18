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

`train_state_from_flax(params, mu, nu, count, step, rng, batch_stats)`
carries a JAX learner across, not only its net: the Adam moments `mu`
and `nu` are elementwise in their parameter, so each moves through its
parameter's map, the running statistics of a batch-norm net map as in
`flax_to_torch`, and the result is `rl/trainer.py::Trainer.get_state`'s
snapshot (the form `stats/persistence.py` writes). The moments and
count sit in the `ScaleByAdamState` of the JAX optimizer chain
(`alphatriangle_tpu/rl/trainer.py::make_optimizer`).

`flax_inference_to_torch(variables)` takes a variables tree the JAX
precision policy made (`cast_params_for_inference`: bf16 leaves, or
int8 `{"q", "scale"}` marker dicts) and returns the port's leaf form of
the same policy (`nn/precision.py`), dtypes kept: a marker's `q` and
`scale` each move through their kernel's map, so the scale lands on the
port's channel axis.
"""

from collections.abc import Mapping

import numpy as np
import torch

_ATTN_IN = ("query", "key", "value")


def _is_marker(value) -> bool:
    return isinstance(value, Mapping) and set(value) == {"q", "scale"}


def _flatten(tree: Mapping, prefix: tuple = (), keep_dtype: bool = False) -> dict:
    out = {}
    for name, value in tree.items():
        path = prefix + (name,)
        if isinstance(value, Mapping) and not (keep_dtype and _is_marker(value)):
            out.update(_flatten(value, path, keep_dtype))
        elif keep_dtype:
            out[path] = value
        else:
            out[path] = np.array(value, dtype=np.float32)  # a writable copy
    return out


def _tensor(value: np.ndarray) -> torch.Tensor:
    """A numpy array (bfloat16 included, through its bits) as a tensor."""
    value = np.ascontiguousarray(value)
    if value.dtype.name == "bfloat16":
        return torch.from_numpy(value.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(value.copy())


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
    state = _param_tensors(variables.get("params", {}))
    stats_names = {"mean": "running_mean", "var": "running_var"}
    for path, value in _flatten(variables.get("batch_stats", {})).items():
        name = stats_names[path[-1]]
        state[".".join(path[:-1] + (name,))] = torch.from_numpy(np.ascontiguousarray(value))
    return state


def _param_tensors(tree: Mapping) -> dict[str, torch.Tensor]:
    out = {}
    for path, value in _flatten(tree).items():
        name, arr = _param_leaf(path, value)
        out[".".join(path[:-1] + (name,))] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def flax_inference_to_torch(variables: Mapping) -> dict:
    """A JAX cast or quantized variables tree -> the port's leaf form:
    a state dict of bf16 (or f32) tensors and `{"q", "scale"}` dicts."""
    out = {}
    for path, value in _flatten(variables.get("params", {}), keep_dtype=True).items():
        if _is_marker(value):
            name, q = _param_leaf(path, np.asarray(value["q"]))
            _, scale = _param_leaf(path, np.asarray(value["scale"]))
            out[".".join(path[:-1] + (name,))] = {"q": _tensor(q), "scale": _tensor(scale)}
        else:
            name, arr = _param_leaf(path, np.asarray(value))
            out[".".join(path[:-1] + (name,))] = _tensor(arr)
    stats_names = {"mean": "running_mean", "var": "running_var"}
    for path, value in _flatten(variables.get("batch_stats", {}), keep_dtype=True).items():
        out[".".join(path[:-1] + (stats_names[path[-1]],))] = _tensor(np.asarray(value))
    return out


def train_state_from_flax(
    params: Mapping, mu: Mapping, nu: Mapping, count, step, rng, batch_stats: "Mapping | None" = None
) -> dict:
    """A JAX learner's state (numpy Flax trees of the parameters and the
    two Adam moments, the optimizer count, the step, the threefry key
    and, for a batch-norm net, the running statistics) as
    `Trainer.get_state`'s snapshot: {"params", "batch_stats",
    "opt_state": {"count", "mu", "nu"}, "step", "rng"}, CPU tensors
    keyed by the port's parameter and buffer names."""
    stats = flax_to_torch({"batch_stats": batch_stats or {}})
    return {
        "batch_stats": stats,
        "params": _param_tensors(params),
        "opt_state": {
            "count": int(np.asarray(count)),
            "mu": _param_tensors(mu),
            "nu": _param_tensors(nu),
        },
        "step": int(np.asarray(step)),
        "rng": torch.from_numpy(np.asarray(rng).astype(np.int64).reshape(2)),
    }
