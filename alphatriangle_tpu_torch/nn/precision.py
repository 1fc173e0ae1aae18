"""Inference precision policy: counterpart of `alphatriangle_tpu/nn/precision.py`.

`ModelConfig.INFERENCE_PRECISION` selects the form in which the
inference paths (self-play chunks, the megastep's rollout, the policy
service, the arena) read the net's weights. The learner always trains
the float32 module and its running statistics.

- "float32": the identity, the same object and no copy.
- "bfloat16": every floating parameter and running statistic cast to
  bf16.
- "int8": weight-only, symmetric per channel. Every matrix leaf becomes
  `{"q": int8, "scale": float32}` with `scale = max(absmax / 127,
  1e-12)` over all axes but the channel axis and `q = clip(round(x /
  scale), -127, 127)`; vectors (biases, norm scales, running statistics)
  are cast to bf16. A forward dequantizes to `(q.float() * scale).to(bf16)`.

The channel groups are the Flax ones (the last axis of the JAX kernel),
measured in the port's layout (`nn/convert.py`):

- Dense `(out, in)`, Conv OIHW, attention `out` `(D, H*hd)`: axis 0;
- attention `query`/`key`/`value` `(H*hd, D)`: the JAX kernel is
  `(D, H, hd)`, so a scale belongs to one `hd` index, shared across the
  heads: the absmax runs over `(H, D)` of the `(H, hd, D)` view, and the
  scale is stored as `(hd, 1)`;
- the q/k/v biases are 2-D `(H, hd)` in JAX, so they are quantized per
  `hd` too (scale `(hd,)`), although the port stores them flat.

These leaf forms are what `nn/convert.py::flax_inference_to_torch`
makes of a JAX cast or quantized tree, so the two compare leaf for leaf.
The sinusoidal `positional` buffer is a constant in JAX, not a variable:
it is not in the state dict and keeps the module's compute dtype.

`InferenceNet` is one weights version at a reduced precision, as the
search reads it. It holds no module of its own: a skeleton of the f32
module per thread (its parameter slots empty, `positional` kept) runs
the forward on the copy's tensors, so producer threads share one copy
without sharing a module's attributes. For int8 it holds the matrices
packed into one int8 buffer and one row-scale vector per row length
(`QuantizedGroups`), so a dequantization is one `torch.mul` per
group (8 at the default net) into bf16 views, bit-identical to the
leaf-by-leaf form. `apply(model, grid, other)` is the evaluation choke
point (`mcts/search.py::BatchedMCTS._evaluate`,
`nn/network.py::NeuralNetwork.evaluate_features`): it dequantizes an
int8 copy there, once per call, and runs anything else as it is.
"""

import copy
import threading
from collections.abc import Mapping

import torch

from ..config.model_config import ModelConfig

_Q_MAX = 127.0
_SCALE_EPS = 1e-12
_ATTN_IN = ("query", "key", "value")


def inference_dtype(model_config: ModelConfig) -> torch.dtype:
    """bf16 under "bfloat16" and "int8" (which dequantizes to bf16), f32
    otherwise; `== torch.float32` is the callers' identity test."""
    if model_config.INFERENCE_PRECISION in ("bfloat16", "int8"):
        return torch.bfloat16
    return torch.float32


def is_quantized_leaf(x) -> bool:
    """True for one `{"q", "scale"}` leaf (an int8 matrix)."""
    return isinstance(x, Mapping) and set(x.keys()) == {"q", "scale"}


def _attention_input(name: str) -> bool:
    """A q/k/v projection leaf (`...MultiHeadDotProductAttention_i.query.weight`)."""
    parts = name.split(".")
    return (
        len(parts) >= 3
        and parts[-3].startswith("MultiHeadDotProductAttention")
        and parts[-2] in _ATTN_IN
    )


def _channel_view(name: str, shape: tuple, heads: int) -> "tuple[tuple, tuple, tuple] | None":
    """(view shape, axes reduced, scale shape) of a quantized leaf in the
    port's layout, or None for a leaf that is cast to bf16."""
    if _attention_input(name):
        hd = shape[0] // heads
        if len(shape) == 2:  # (H*hd, D): the JAX (D, H, hd) kernel
            return (heads, hd, shape[1]), (0, 2), (hd, 1)
        return (heads, hd), (0,), (hd,)  # the (H, hd) bias
    if len(shape) >= 2:  # Dense / out (out, in), Conv OIHW: channel axis 0
        return shape, tuple(range(1, len(shape))), (shape[0],) + (1,) * (len(shape) - 1)
    return None


def _quantize_leaf(x: torch.Tensor, view: tuple, axes: tuple, scale_shape: tuple) -> dict:
    xf = x.float().reshape(view)
    absmax = xf.abs().amax(dim=axes, keepdim=True)
    # A tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which is not the correctly rounded quotient.
    scale = torch.clamp(absmax / absmax.new_full((), _Q_MAX), min=_SCALE_EPS)
    q = torch.clamp(torch.round(xf / scale), -_Q_MAX, _Q_MAX).to(torch.int8)
    return {"q": q.reshape(x.shape), "scale": scale.reshape(scale_shape)}


def _cast_floats(state: Mapping, dtype: torch.dtype) -> dict:
    """`state` with its floating tensors cast to `dtype` in two launches
    (one concatenation, one cast) instead of one per tensor; the results
    are views of one buffer."""
    names = [n for n, t in state.items() if torch.is_floating_point(t)]
    out = dict(state)
    if not names:
        return out
    flat = torch.cat([state[n].detach().reshape(-1).float() for n in names]).to(dtype)
    offset = 0
    for n in names:
        size = state[n].numel()
        out[n] = flat[offset : offset + size].view(state[n].shape)
        offset += size
    return out


def quantize_params_for_inference(state: Mapping, model_config: ModelConfig) -> dict:
    """Weight-only int8 of a state dict: matrix leaves (and the q/k/v
    biases) become `{"q", "scale"}`, other floating leaves bf16."""
    heads = model_config.TRANSFORMER_HEADS
    out, vectors = {}, {}
    for name, x in state.items():
        if not torch.is_floating_point(x):
            out[name] = x
            continue
        layout = _channel_view(name, tuple(x.shape), heads)
        if layout is None:
            vectors[name] = x
        else:
            out[name] = _quantize_leaf(x.detach(), *layout)
    out.update(_cast_floats(vectors, torch.bfloat16))
    return {name: out[name] for name in state}


def _dequantize_leaf(leaf: Mapping) -> torch.Tensor:
    q, scale = leaf["q"], leaf["scale"]
    if scale.dim() == 2 and q.dim() == 2 and scale.shape[0] != q.shape[0]:  # q/k/v weight
        view = (q.shape[0] // scale.shape[0], scale.shape[0], q.shape[1])
    elif scale.dim() == 1 and q.shape != scale.shape:  # q/k/v bias
        view = (q.shape[0] // scale.shape[0], scale.shape[0])
    else:
        view = q.shape
    return (q.reshape(view).float() * scale).to(torch.bfloat16).reshape(q.shape)


def dequantize_params(params):
    """A state dict for the forward: `{"q", "scale"}` leaves, or a whole
    `QuantizedGroups`, dequantized to bf16; other leaves as they are."""
    if isinstance(params, QuantizedGroups):
        return params.dequantize()
    return {n: _dequantize_leaf(v) if is_quantized_leaf(v) else v for n, v in params.items()}


def cast_params_for_inference(state: Mapping, model_config: ModelConfig):
    """The precision policy on a state dict: the same object under
    float32, floating leaves cast under bfloat16, the int8 leaf form
    under int8."""
    if model_config.INFERENCE_PRECISION == "int8":
        return quantize_params_for_inference(state, model_config)
    dtype = inference_dtype(model_config)
    if dtype == torch.float32:
        return state
    return _cast_floats(state, dtype)


def quantized_param_bytes(params) -> int:
    """Bytes of a (cast or quantized) state dict as the forward reads
    it: a quantized leaf counts its int8 and scale tensors (JAX's count)."""
    total = 0
    for v in params.values():
        for t in (v["q"], v["scale"]) if is_quantized_leaf(v) else (v,):
            total += t.numel() * t.element_size()
    return total


class QuantizedGroups:
    """The int8 leaves of one state dict packed by row length: each leaf
    seen as (rows, L) with one scale per row (a q/k/v leaf repeats its
    `hd` scales over the heads) joins the group of its L, an int8
    (rows, L) buffer and a float32 (rows,) scale vector. `dequantize` is
    one `torch.mul` per group, computed in float32 and rounded to bf16
    as the leaf form is; bf16 leaves are kept as they are."""

    def __init__(self, leaves: Mapping):
        self.names = list(leaves)
        self.plain = {n: v for n, v in leaves.items() if not is_quantized_leaf(v)}
        by_len: dict[int, list] = {}
        for name, leaf in leaves.items():
            if not is_quantized_leaf(leaf):
                continue
            q, scale = leaf["q"], leaf["scale"]
            rows = q.shape[0]
            row_scale = scale.reshape(-1)
            if row_scale.numel() != rows:  # q/k/v: hd scales tiled over the heads
                row_scale = row_scale.repeat(rows // row_scale.numel())
            by_len.setdefault(q.numel() // rows, []).append((name, q.reshape(rows, -1), row_scale))
        self.groups = []  # (q (R, L) int8, scale (R,) f32, [(name, first row, shape)])
        for members in by_len.values():
            q = torch.cat([m[1] for m in members])
            scale = torch.cat([m[2] for m in members])
            index, row = [], 0
            for name, qm, _ in members:
                index.append((name, row, tuple(leaves[name]["q"].shape)))
                row += qm.shape[0]
            self.groups.append((q, scale, index))

    @property
    def launches(self) -> int:
        """Kernels one `dequantize` launches."""
        return len(self.groups)

    def tensors(self) -> list:
        return [t for q, s, _ in self.groups for t in (q, s)] + list(self.plain.values())

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def dequantize(self) -> dict:
        out = dict(self.plain)
        for q, scale, index in self.groups:
            deq = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
            torch.mul(q, scale[:, None], out=deq)
            for name, row, shape in index:
                rows = shape[0]
                out[name] = deq[row : row + rows].view(shape)
        return {n: out[n] for n in self.names}


class InferenceNet:
    """One weights version at the inference precision: the cast tensors
    (bf16) or the packed int8 groups, and the module skeleton that runs
    them. Built on the device of `module`, on the current stream;
    `ready` (set by the owner) orders a read from another stream. Not
    callable: the forward goes through `apply`, the choke point."""

    casts = 0  # InferenceNets built, over the process
    _count_lock = threading.Lock()

    def __init__(self, module: torch.nn.Module, model_config: ModelConfig):
        if inference_dtype(model_config) == torch.float32:
            raise ValueError("float32 inference reads the module itself")
        self.precision = model_config.INFERENCE_PRECISION
        slots, state = [], {}
        for mod_name, mod in module.named_modules():
            prefix = f"{mod_name}." if mod_name else ""
            for attr, t in mod._parameters.items():
                if t is not None:
                    slots.append((mod_name, "_parameters", attr, prefix + attr))
                    state[prefix + attr] = t.detach()
            for attr, t in mod._buffers.items():
                if t is not None and attr not in mod._non_persistent_buffers_set:
                    slots.append((mod_name, "_buffers", attr, prefix + attr))
                    state[prefix + attr] = t
        with torch.no_grad():
            cast = cast_params_for_inference(state, model_config)
        self.params = QuantizedGroups(cast) if self.precision == "int8" else cast
        # The skeleton: the module with every parameter and persistent
        # buffer slot emptied (deepcopy's memo maps each to None).
        memo = {id(t): None for mod in module.modules() for t in (
            *mod._parameters.values(),
            *(b for a, b in mod._buffers.items() if a not in mod._non_persistent_buffers_set),
        ) if t is not None}
        self._template = copy.deepcopy(module, memo).eval()
        self._slots = slots
        self._local = threading.local()
        self.ready = None
        with InferenceNet._count_lock:
            InferenceNet.casts += 1

    def tensors(self) -> list:
        """Every tensor the copy holds (for a hand-over between streams)."""
        if isinstance(self.params, QuantizedGroups):
            return self.params.tensors()
        return list(self.params.values())

    def nbytes(self) -> int:
        """Bytes the copy holds on its device."""
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def run(self, params: Mapping, grid: torch.Tensor, other: torch.Tensor):
        """The forward on `params` (a full state dict, already
        dequantized) with this thread's skeleton."""
        skeleton = getattr(self._local, "module", None)
        if skeleton is None:
            skeleton = self._local.module = copy.deepcopy(self._template)
            self._local.owners = dict(skeleton.named_modules())
        owners = self._local.owners
        for mod_name, kind, attr, key in self._slots:
            getattr(owners[mod_name], kind)[attr] = params[key]
        return skeleton(grid, other)


def apply(model, grid: torch.Tensor, other: torch.Tensor):
    """The evaluation choke point: `model` on a batch, where an int8
    `InferenceNet` dequantizes its weights first (a bf16 one reads its
    cast tensors); a module or a stub runs as it is."""
    if isinstance(model, InferenceNet):
        return model.run(dequantize_params(model.params), grid, other)
    return model(grid, other)
