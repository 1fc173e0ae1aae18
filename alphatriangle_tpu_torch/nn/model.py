"""Policy/value network: counterpart of `alphatriangle_tpu/nn/model.py`.

conv trunk -> residual blocks -> optional pre-norm transformer encoder
over the flattened spatial sequence (sinusoidal positions) -> flatten
-> concat `other_features` -> shared FC -> policy-logit head + C51
value head.

Submodules carry the Flax module names (`ConvBlock_0.Conv_0`,
`TransformerEncoderLayer_0.MultiHeadDotProductAttention_0.query`, ...)
so `nn/convert.py` maps a Flax variables tree onto the state dict leaf
for leaf. What the Flax model does and this one repeats:

- Convolutions run NCHW here, but the sequence and the flatten are in
  NHWC token order `(h, w, c)`, so the first shared Dense sees the
  Flax layout.
- Norms use eps 1e-6 (GroupNorm, LayerNorm) with the fast variance
  E[x^2] - E[x]^2 in float32; GroupNorm's group count is
  `_group_count(channels)`. BatchNorm (eps 1e-5, momentum 0.99) is
  `flax.linen.BatchNorm`: batch statistics and a running-statistics
  update in `train()` mode, the running statistics in `eval()` mode.
- Under `COMPUTE_DTYPE="bfloat16"` every conv, dense and attention
  product runs in bf16 on f32 parameters cast per call; the norm
  statistics stay f32 and each head's output Dense runs in f32.
- Attention scales the query by 1/sqrt(head_dim) before the product,
  and runs in slices of the batch that hold at most `SCORE_BUDGET`
  scores: a search's leaf batch at preset 5 (32,768 sequences of 252
  tokens, 4 heads) would otherwise hold 8.3e9 scores three times over
  (bf16 logits, their f32 copy and the f32 softmax: 83 GB). Rows are
  independent, so the slices change no value.
- `ModelConfig.REMAT` recomputes each residual block and transformer
  layer in the backward pass (`torch.utils.checkpoint`, as `nn.remat`
  in the JAX model) when the net trains with gradients; a layer's
  dropout masks are drawn again from the same generator state, so the
  gradients equal those without it.
- `attention_fn` (`parallel/ring_attention.make_sp_attention`) replaces
  the dense attention core of every transformer layer, as the Flax
  model's does: it receives the unscaled (B, T, H, hd) query, key and
  value and returns (B, T, H, hd), and attention-weight dropout is off
  under it while the residual dropouts stay.
- Tensor parallelism (`tensor_parallel_`, over the mesh's mdl axis,
  Megatron layout of `parallel.sharding.tp_spec`): a layer's q / k / v
  hold this rank's heads and `out` their columns; `Dense_0` holds its
  hidden columns and `Dense_1` their rows. The replicated input of each
  column-parallel part passes `copy_to_mdl` and each row-parallel
  product `reduce_from_mdl`, before its replicated bias is added once.
  A width that does not divide by mdl leaves its part replicated. The
  dropout mask of the sharded MLP hidden is drawn at full width and
  sliced, so it is this rank's columns of the replicated layer's mask.
- Plain matmuls and convolutions (`torch.nn.functional`), as the JAX
  package left them to XLA: none of this is a hand-written kernel.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config.model_config import ModelConfig
from ..parallel.sharding import copy_to_mdl, reduce_from_mdl, shard_tensor, state_shardings

_NORM_EPS = 1e-6
_BATCH_NORM_EPS = 1e-5  # flax.linen.BatchNorm's default
# Attention scores (sequences x heads x tokens x tokens) one slice of the
# batch may hold: 2 GB of bf16 logits, whose f32 copy and softmax add 8.
# The default board's leaf batch (16,384 x 4 x 120 x 120) fits in one.
SCORE_BUDGET = 1 << 30

_ACTIVATIONS = {
    "ReLU": F.relu,
    # flax.linen.gelu defaults to the tanh approximation.
    "GELU": lambda x: F.gelu(x, approximate="tanh"),
    "SiLU": F.silu,
    "Tanh": torch.tanh,
    "Sigmoid": torch.sigmoid,
}


def _group_count(features: int, preferred: int = 8) -> int:
    """Largest divisor of `features` that is <= preferred."""
    g = min(preferred, features)
    while features % g != 0:
        g -= 1
    return g


def sinusoidal_positional_encoding(seq_len: int, dim: int) -> np.ndarray:
    """(seq_len, dim) float32 sin/cos table."""
    position = np.arange(seq_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, dim, 2, dtype=np.float32) * (-np.log(10000.0) / dim)
    )
    pe = np.zeros((seq_len, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: pe[:, 1::2].shape[1]])
    return pe


def _fast_stats(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """Flax's `_compute_stats` with `use_fast_variance=True`, in f32."""
    x = x.float()
    mean = x.mean(dim=dims, keepdim=True)
    var = (x * x).mean(dim=dims, keepdim=True) - mean * mean
    return mean, var.clamp(min=0.0)


class Dense(nn.Module):
    """`flax.linen.Dense`: x @ kernel + bias in `dtype`."""

    def __init__(self, fan_in: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, fan_in))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class Conv(nn.Module):
    """`flax.linen.Conv` with SAME padding over NCHW input."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.kernel, self.stride, self.dtype = kernel, stride, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(self.dtype), self.bias.to(self.dtype)
        x = x.to(self.dtype)
        k, s = self.kernel, self.stride
        if s == 1:
            return F.conv2d(x, w, b, padding="same")
        # XLA SAME padding: total = max((ceil(n/s)-1)*s + k - n, 0),
        # split low = total // 2.
        pads = []
        for n in (x.shape[-1], x.shape[-2]):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return F.conv2d(F.pad(x, pads), w, b, stride=s)


class GroupNorm(nn.Module):
    """`flax.linen.GroupNorm` over the channel dim 1 (NCHW) or the last
    dim (2-D input)."""

    def __init__(self, channels: int, dtype):
        super().__init__()
        self.groups = _group_count(channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.groups
        if x.dim() == 4:
            b, c, h, w = x.shape
            xg = x.reshape(b, g, c // g, h, w)
            mean, var = _fast_stats(xg, (2, 3, 4))
            shape = (1, c, 1, 1)
            mean = mean.expand(b, g, c // g, 1, 1).reshape(b, c, 1, 1)
            var = var.expand(b, g, c // g, 1, 1).reshape(b, c, 1, 1)
        else:
            lead, c = x.shape[:-1], x.shape[-1]
            xg = x.reshape(*lead, g, c // g)
            mean, var = _fast_stats(xg, (-1,))
            shape = (c,)
            mean = mean.expand(*lead, g, c // g).reshape(*lead, c)
            var = var.expand(*lead, g, c // g).reshape(*lead, c)
        return _normalize(x, mean, var, self.weight.reshape(shape), self.bias.reshape(shape), self.dtype)


class LayerNorm(nn.Module):
    """`flax.linen.LayerNorm` over the last dim."""

    def __init__(self, features: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = _fast_stats(x, (-1,))
        return _normalize(x, mean, var, self.weight, self.bias, self.dtype)


class BatchNorm(nn.Module):
    """`flax.linen.BatchNorm` (momentum 0.99, eps 1e-5) over the channel
    dim 1 (NCHW) or the last dim (2-D input).

    In `train()` mode it normalises with the batch's statistics over
    (N, H, W) or (N,), in f32 by the fast variance, and moves the
    running statistics to `0.99 * running + 0.01 * batch` with the
    biased variance, once per forward: not when `update_stats` is off,
    which the residual blocks' recomputation under REMAT sets (Flax's
    `nn.remat` updates once). In `eval()` mode it reads the running
    statistics. In a dp learner (`sync_stats`) the batch statistics are
    the global batch's, as Flax's layer takes them under GSPMD. The
    arithmetic follows Flax's `_normalize` in its operands' dtypes: f32
    statistics promote the compute-dtype input to f32, and with bf16
    statistics, scale and bias (the inference copy of `nn/precision.py`)
    the whole norm runs in bf16.
    """

    momentum = 0.99

    def __init__(self, features: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.dtype = dtype
        self.update_stats = True
        # (x, dims) -> (mean, var) over the global batch of a dp learner
        # (`parallel.sharding.synced_batch_stats`); None: this batch's.
        self.sync_stats = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1) if x.dim() == 4 else (-1,)
        if self.training:
            stats = _fast_stats if self.sync_stats is None else self.sync_stats
            mean, var = stats(x, (0, 2, 3) if x.dim() == 4 else (0,))
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean.detach().reshape(-1))
                    self.running_var.copy_(m * self.running_var + (1 - m) * var.detach().reshape(-1))
        else:
            mean, var = self.running_mean.reshape(shape), self.running_var.reshape(shape)
        y = x - mean
        # rsqrt in f32, rounded to the statistics' dtype, as XLA computes
        # a bf16 rsqrt (torch's own bf16 rsqrt differs in the last bit).
        mul = torch.rsqrt((var + _BATCH_NORM_EPS).float()).to(var.dtype) * self.weight.reshape(shape)
        y = y * mul + self.bias.reshape(shape)
        return y.to(self.dtype)


def _normalize(x, mean, var, scale, bias, dtype) -> torch.Tensor:
    y = (x.float() - mean) * (torch.rsqrt(var + _NORM_EPS) * scale)
    return (y + bias).to(dtype)


class _Norm(nn.Module):
    """The norm selected by `ModelConfig.NORM_TYPE`, under the Flax
    wrapper's own name (`_Norm_i.GroupNorm_0`, ...)."""

    def __init__(self, norm_type: str, channels: int, dtype):
        super().__init__()
        self.norm_type = norm_type
        if norm_type == "group":
            self.GroupNorm_0 = GroupNorm(channels, dtype)
        elif norm_type == "layer":
            self.LayerNorm_0 = LayerNorm(channels, dtype)
        elif norm_type == "batch":
            self.BatchNorm_0 = BatchNorm(channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_type == "group":
            return self.GroupNorm_0(x)
        if self.norm_type == "layer":
            if x.dim() == 4:  # Flax normalizes the channel-last axis.
                return self.LayerNorm_0(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            return self.LayerNorm_0(x)
        if self.norm_type == "batch":
            return self.BatchNorm_0(x)
        return x


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, kernel, stride, norm_type, act, dtype):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel, stride, dtype)
        self._Norm_0 = _Norm(norm_type, cout, dtype)
        self.act = act

    def forward(self, x):
        return self.act(self._Norm_0(self.Conv_0(x)))


class ResidualBlock(nn.Module):
    def __init__(self, features, norm_type, act, dtype):
        super().__init__()
        self.Conv_0 = Conv(features, features, 3, 1, dtype)
        self._Norm_0 = _Norm(norm_type, features, dtype)
        self.Conv_1 = Conv(features, features, 3, 1, dtype)
        self._Norm_1 = _Norm(norm_type, features, dtype)
        self.act = act

    def forward(self, x):
        residual = x
        x = self.act(self._Norm_0(self.Conv_0(x)))
        x = self._Norm_1(self.Conv_1(x))
        return self.act(x + residual)


class MultiHeadDotProductAttention(nn.Module):
    """Flax MHA (self-attention): q/k/v `DenseGeneral` D -> (H, hd),
    query scaled by 1/sqrt(hd), softmax over keys, out (H, hd) -> D; or
    `attention_fn` on the unscaled projections. Under tensor parallelism
    (`tp`, a mesh) it holds `local_heads` of the H heads."""

    def __init__(self, dim: int, heads: int, dtype, attention_fn=None):
        super().__init__()
        self.heads, self.head_dim, self.dtype = heads, dim // heads, dtype
        self.local_heads = heads
        self.attention_fn = attention_fn
        self.tp = None
        self.query = Dense(dim, dim, dtype)
        self.key = Dense(dim, dim, dtype)
        self.value = Dense(dim, dim, dtype)
        self.out = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor, dropout=None) -> torch.Tensor:
        b, t, _ = x.shape
        h, hd = self.local_heads, self.head_dim
        if self.tp is not None:
            x = copy_to_mdl(x, self.tp)
        if self.attention_fn is not None:
            q, k, v = (proj(x).reshape(b, t, h, hd) for proj in (self.query, self.key, self.value))
            y = self.attention_fn(q, k, v, deterministic=not self.training).reshape(b, t, h * hd)
            return self._project(y)

        def split(y):
            return y.reshape(b, t, h, hd).transpose(1, 2)  # (b, h, t, hd)

        q = split(self.query(x))
        k = split(self.key(x))
        v = split(self.value(x))
        q = q / torch.tensor(math.sqrt(hd), dtype=q.dtype)
        scale = None
        if dropout is not None:
            # Flax broadcasts the attention-weight mask over batch and
            # heads, and scales by 1/keep in the compute dtype.
            rate, gen = dropout
            keep = 1.0 - rate
            mask = torch.rand((t, t), generator=gen, device=x.device) < keep
            scale = mask.to(self.dtype) / torch.tensor(keep, dtype=self.dtype)
        rows = max(1, SCORE_BUDGET // (h * t * t))
        ys = []
        for s in range(0, b, rows):
            logits = torch.matmul(q[s : s + rows], k[s : s + rows].transpose(-1, -2))
            weights = torch.softmax(logits.float(), dim=-1).to(self.dtype)
            del logits
            if scale is not None:
                weights = weights * scale
            ys.append(torch.matmul(weights, v[s : s + rows]))
        y = ys[0] if len(ys) == 1 else torch.cat(ys)
        return self._project(y.transpose(1, 2).reshape(b, t, h * hd))

    def _project(self, y: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.out(y)
        return _row_parallel(self.out, y, self.tp)


def _row_parallel(dense: "Dense", y: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel Dense: this rank's rows' product, summed over mdl,
    then the replicated bias once."""
    dt = dense.dtype
    partial = F.linear(y.to(dt), dense.weight.to(dt))
    return reduce_from_mdl(partial, mesh) + dense.bias.to(dt)


def dropout(
    x: torch.Tensor, rate: float, gen: torch.Generator, shard: "tuple | None" = None
) -> torch.Tensor:
    """`flax.linen.Dropout` in train mode: keep each element with
    probability 1 - rate and scale the kept ones by 1 / (1 - rate).
    `shard` (n, i): x is column block i of n of the full tensor, whose
    mask is drawn whole and sliced."""
    keep = 1.0 - rate
    if shard is None:
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    else:
        n, i = shard
        full = torch.rand((*x.shape[:-1], x.shape[-1] * n), generator=gen, device=x.device)
        mask = full.chunk(n, dim=-1)[i] < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class TransformerEncoderLayer(nn.Module):
    """Pre-norm encoder layer. In `train()` mode dropout of `dropout_rate`
    applies to the attention weights (not under `attention_fn`) and to
    the inputs of both residual adds (and between the two MLP denses),
    as in the Flax layer, with masks drawn from the generator the caller
    passes; in `eval()` mode it is the identity. `tp` (a mesh) runs the
    MLP tensor-parallel (`nn/model.py` docstring)."""

    def __init__(self, dim, heads, mlp_dim, act, dtype, dropout_rate: float = 0.1, attention_fn=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(dim, heads, dtype, attention_fn)
        self.LayerNorm_1 = LayerNorm(dim, dtype)
        self.Dense_0 = Dense(dim, mlp_dim, dtype)
        self.Dense_1 = Dense(mlp_dim, dim, dtype)
        self.act = act
        self.dropout_rate = dropout_rate
        self.tp = None

    def forward(self, x, generator: "torch.Generator | None" = None):
        rate = self.dropout_rate if self.training else 0.0
        if rate > 0.0 and generator is None:
            raise ValueError("train-mode dropout needs an explicit torch.Generator")
        tp = self.tp

        def drop(y, shard=None):
            return dropout(y, rate, generator, shard) if rate > 0.0 else y

        attn = self.MultiHeadDotProductAttention_0
        attn_drop = (rate, generator) if rate > 0.0 and attn.attention_fn is None else None
        y = attn(self.LayerNorm_0(x), dropout=attn_drop)
        x = x + drop(y)
        y = self.LayerNorm_1(x)
        if tp is None:
            y = drop(self.act(self.Dense_0(y)))
            return x + drop(self.Dense_1(y))
        y = drop(self.act(self.Dense_0(copy_to_mdl(y, tp))), (tp.mdl, tp.mdl_index))
        return x + drop(_row_parallel(self.Dense_1, y, tp))


class MLPHead(nn.Module):
    """Dense stack with norm/act, then an f32 output Dense."""

    def __init__(self, fan_in, hidden_dims, out_dim, norm_type, act, dtype):
        super().__init__()
        self.act = act
        self.n_hidden = len(hidden_dims)
        for i, h in enumerate(hidden_dims):
            setattr(self, f"Dense_{i}", Dense(fan_in, h, dtype))
            setattr(self, f"_Norm_{i}", _Norm(norm_type, h, dtype))
            fan_in = h
        setattr(self, f"Dense_{self.n_hidden}", Dense(fan_in, out_dim, torch.float32))

    def forward(self, x):
        for i in range(self.n_hidden):
            x = self.act(getattr(self, f"_Norm_{i}")(getattr(self, f"Dense_{i}")(x)))
        return getattr(self, f"Dense_{self.n_hidden}")(x)


class AlphaTriangleNet(nn.Module):
    """Policy + C51 value network over (grid, other_features)."""

    def __init__(self, config: ModelConfig, action_dim: int, rows: int, cols: int, attention_fn=None):
        super().__init__()
        cfg = config
        self.config = cfg
        dtype = torch.bfloat16 if cfg.COMPUTE_DTYPE == "bfloat16" else torch.float32
        self.dtype = dtype
        act = _ACTIVATIONS[cfg.ACTIVATION_FUNCTION]
        self.act = act
        h, w = rows, cols
        ch = cfg.GRID_INPUT_CHANNELS
        blocks = []
        for f, k, s in zip(cfg.CONV_FILTERS, cfg.CONV_KERNEL_SIZES, cfg.CONV_STRIDES, strict=True):
            blocks.append(ConvBlock(ch, f, k, s, cfg.NORM_TYPE, act, dtype))
            ch, h, w = f, -(-h // s), -(-w // s)
        if cfg.NUM_RESIDUAL_BLOCKS > 0 and ch != cfg.RESIDUAL_BLOCK_FILTERS:
            blocks.append(ConvBlock(ch, cfg.RESIDUAL_BLOCK_FILTERS, 1, 1, cfg.NORM_TYPE, act, dtype))
            ch = cfg.RESIDUAL_BLOCK_FILTERS
        self.n_conv_blocks = len(blocks)
        for i, blk in enumerate(blocks):
            setattr(self, f"ConvBlock_{i}", blk)
        self.n_res = cfg.NUM_RESIDUAL_BLOCKS
        for i in range(self.n_res):
            setattr(self, f"ResidualBlock_{i}", ResidualBlock(ch, cfg.NORM_TYPE, act, dtype))

        self.use_transformer = cfg.USE_TRANSFORMER and cfg.TRANSFORMER_LAYERS > 0
        self.project = False
        if self.use_transformer:
            d = cfg.TRANSFORMER_DIM
            if ch != d:
                self.Conv_0 = Conv(ch, d, 1, 1, dtype)
                self.project = True
                ch = d
            pe = torch.from_numpy(sinusoidal_positional_encoding(h * w, d)).to(dtype)
            self.register_buffer("positional", pe, persistent=False)
            self.n_layers = cfg.TRANSFORMER_LAYERS
            for i in range(self.n_layers):
                setattr(
                    self,
                    f"TransformerEncoderLayer_{i}",
                    TransformerEncoderLayer(
                        d, cfg.TRANSFORMER_HEADS, cfg.TRANSFORMER_FC_DIM, act, dtype,
                        attention_fn=attention_fn,
                    ),
                )
            self.LayerNorm_0 = LayerNorm(d, dtype)

        fan_in = h * w * ch + cfg.OTHER_NN_INPUT_FEATURES_DIM
        self.n_shared = len(cfg.FC_DIMS_SHARED)
        for i, hdim in enumerate(cfg.FC_DIMS_SHARED):
            setattr(self, f"Dense_{i}", Dense(fan_in, hdim, dtype))
            setattr(self, f"_Norm_{i}", _Norm(cfg.NORM_TYPE, hdim, dtype))
            fan_in = hdim
        self.MLPHead_0 = MLPHead(fan_in, cfg.POLICY_HEAD_DIMS, action_dim, cfg.NORM_TYPE, act, dtype)
        self.MLPHead_1 = MLPHead(
            fan_in, cfg.VALUE_HEAD_DIMS, cfg.NUM_VALUE_ATOMS, cfg.NORM_TYPE, act, dtype
        )

    def set_attention_fn(self, attention_fn) -> None:
        """Swap every transformer layer's attention core (None: dense)."""
        for m in self.modules():
            if isinstance(m, MultiHeadDotProductAttention):
                m.attention_fn = attention_fn

    def forward(
        self, grid: torch.Tensor, other: torch.Tensor, generator: "torch.Generator | None" = None
    ):
        """(B, C, H, W) grid + (B, F) extras -> (B, A) policy logits,
        (B, NUM_VALUE_ATOMS) value logits, both float32. In `train()`
        mode the transformer's dropout draws its masks from `generator`,
        and batch norms normalise with the batch's statistics and update
        their running ones (once per forward, under REMAT too)."""
        remat = self.config.REMAT and self.training and torch.is_grad_enabled()
        x = grid.to(self.dtype)
        for i in range(self.n_conv_blocks):
            x = getattr(self, f"ConvBlock_{i}")(x)
        for i in range(self.n_res):
            block = getattr(self, f"ResidualBlock_{i}")
            x = _remat_block(block, x) if remat else block(x)
        if self.use_transformer:
            if self.project:
                x = self.Conv_0(x)
            b, d = x.shape[0], x.shape[1]
            tokens = x.permute(0, 2, 3, 1).reshape(b, -1, d)  # NHWC token order
            tokens = tokens + self.positional
            for i in range(self.n_layers):
                layer = getattr(self, f"TransformerEncoderLayer_{i}")
                tokens = _remat_layer(layer, tokens, generator) if remat else layer(tokens, generator)
            flat = self.LayerNorm_0(tokens).reshape(b, -1)
        else:
            flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        shared = torch.cat([flat, other.to(self.dtype)], dim=-1)
        for i in range(self.n_shared):
            shared = self.act(getattr(self, f"_Norm_{i}")(getattr(self, f"Dense_{i}")(shared)))
        policy = self.MLPHead_0(shared)
        value = self.MLPHead_1(shared)
        return policy.float(), value.float()


def tensor_parallel_(model: AlphaTriangleNet, mesh) -> dict:
    """Shard `model`'s transformer layers over the mesh's mdl axis in
    place: each leaf that `tp_spec` splits becomes this rank's shard (a
    new Parameter at the same place in `parameters()`), and the layers
    and attentions that hold shards run tensor-parallel. Returns the
    layout, name -> "replicated" or the split dim. A no-op at mdl = 1."""
    heads = model.config.TRANSFORMER_HEADS
    layout = state_shardings(dict(model.named_parameters()), mesh, heads)
    if mesh.mdl <= 1:
        return layout
    for name, dim in layout.items():
        if dim == "replicated":
            continue
        path, leaf = name.rsplit(".", 1)
        owner = model.get_submodule(path)
        full = getattr(owner, leaf)
        setattr(owner, leaf, nn.Parameter(shard_tensor(full.detach(), dim, mesh),
                                          requires_grad=full.requires_grad))
    for mod_name, mod in model.named_modules():
        if isinstance(mod, TransformerEncoderLayer):
            if layout[f"{mod_name}.Dense_0.weight"] != "replicated":
                mod.tp = mesh
        elif isinstance(mod, MultiHeadDotProductAttention):
            if layout[f"{mod_name}.query.weight"] != "replicated":
                mod.tp = mesh
                mod.local_heads = mod.heads // mesh.mdl
    return layout


def _remat_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """`block(x)` under `torch.utils.checkpoint`, with its batch norms'
    running-statistics update off in the backward pass's recomputation,
    so the statistics move once per forward, as under Flax's `nn.remat`."""
    norms = [m for m in block.modules() if isinstance(m, BatchNorm)]
    calls = []

    def run(y):
        again = bool(calls)
        calls.append(True)
        for m in norms:
            m.update_stats = not again
        try:
            return block(y)
        finally:
            for m in norms:
                m.update_stats = True

    return checkpoint(run, x, use_reentrant=False)


def _remat_layer(layer: nn.Module, tokens: torch.Tensor, generator) -> torch.Tensor:
    """`layer(tokens, generator)` under `torch.utils.checkpoint`. The
    recomputation draws the layer's dropout masks from a copy of the
    generator's state at the call, so they repeat the forward's; the
    generator itself ends where the forward left it."""
    if generator is None:
        return checkpoint(layer, tokens, None, use_reentrant=False)
    start = generator.get_state()
    end = []

    def run(x):
        gen = torch.Generator(device=generator.device)
        gen.set_state(start)
        y = layer(x, gen)
        if not end:
            end.append(gen.get_state())
        return y

    out = checkpoint(run, tokens, use_reentrant=False)
    generator.set_state(end[0])
    return out


def init_parameters(model: nn.Module, seed: int) -> None:
    """Flax's default initialisers from an explicit random stream:
    LeCun-normal kernels (truncated at two deviations), zero biases and
    unit norm scales. The draws follow `seed`, not Flax's bits."""
    gen = torch.Generator().manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, (Dense, Conv)):
            fan_in = mod.weight[0].numel()
            # Truncation at +-2 shrinks the deviation by this factor.
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            with torch.no_grad():
                w = torch.empty(mod.weight.shape).normal_(0.0, 1.0, generator=gen)
                mod.weight.copy_(w.clamp(-2.0, 2.0) * std)
                mod.bias.zero_()


def value_support(cfg: ModelConfig, device=None) -> torch.Tensor:
    """(NUM_VALUE_ATOMS,) float32 C51 atom support, computed as
    `jnp.linspace` computes it: start*(1-t) + stop*t, t = i/(n-1)."""
    n = cfg.NUM_VALUE_ATOMS
    t = torch.arange(n - 1, dtype=torch.float32) / float(n - 1)
    lo = torch.tensor(cfg.VALUE_MIN, dtype=torch.float32)
    hi = torch.tensor(cfg.VALUE_MAX, dtype=torch.float32)
    out = torch.cat([lo * (1.0 - t) + hi * t, hi[None]])
    return out.to(device) if device is not None else out


def expected_value_from_logits(value_logits: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """(..., atoms) logits -> (...,) expected value sum(p_i * z_i)."""
    return (torch.softmax(value_logits, dim=-1) * support).sum(dim=-1)
