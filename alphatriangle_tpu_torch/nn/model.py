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
  `_group_count(channels)`.
- Under `COMPUTE_DTYPE="bfloat16"` every conv, dense and attention
  product runs in bf16 on f32 parameters cast per call; the norm
  statistics stay f32 and each head's output Dense runs in f32.
- Attention scales the query by 1/sqrt(head_dim) before the product.
- Plain matmuls and convolutions (`torch.nn.functional`), as the JAX
  package left them to XLA: none of this is a hand-written kernel.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config.model_config import ModelConfig

_NORM_EPS = 1e-6
_BATCH_NORM_EPS = 1e-5  # flax.linen.BatchNorm's default

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
    """`flax.linen.BatchNorm` in inference mode (running statistics)."""

    def __init__(self, features: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1) if x.dim() == 4 else (-1,)
        y = (x.float() - self.running_mean.reshape(shape)) * (
            torch.rsqrt(self.running_var.reshape(shape) + _BATCH_NORM_EPS)
            * self.weight.reshape(shape)
        ) + self.bias.reshape(shape)
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
    query scaled by 1/sqrt(hd), softmax over keys, out (H, hd) -> D."""

    def __init__(self, dim: int, heads: int, dtype):
        super().__init__()
        self.heads, self.head_dim, self.dtype = heads, dim // heads, dtype
        self.query = Dense(dim, dim, dtype)
        self.key = Dense(dim, dim, dtype)
        self.value = Dense(dim, dim, dtype)
        self.out = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        h, hd = self.heads, self.head_dim

        def split(y):
            return y.reshape(b, t, h, hd).transpose(1, 2)  # (b, h, t, hd)

        q = split(self.query(x))
        k = split(self.key(x))
        v = split(self.value(x))
        q = q / torch.tensor(math.sqrt(hd), dtype=q.dtype)
        logits = torch.matmul(q, k.transpose(-1, -2))
        weights = torch.softmax(logits.float(), dim=-1).to(self.dtype)
        y = torch.matmul(weights, v).transpose(1, 2).reshape(b, t, h * hd)
        return self.out(y)


class TransformerEncoderLayer(nn.Module):
    """Pre-norm encoder layer (inference: dropout is the identity)."""

    def __init__(self, dim, heads, mlp_dim, act, dtype):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(dim, heads, dtype)
        self.LayerNorm_1 = LayerNorm(dim, dtype)
        self.Dense_0 = Dense(dim, mlp_dim, dtype)
        self.Dense_1 = Dense(mlp_dim, dim, dtype)
        self.act = act

    def forward(self, x):
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        y = self.Dense_1(self.act(self.Dense_0(self.LayerNorm_1(x))))
        return x + y


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

    def __init__(self, config: ModelConfig, action_dim: int, rows: int, cols: int):
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
                    TransformerEncoderLayer(d, cfg.TRANSFORMER_HEADS, cfg.TRANSFORMER_FC_DIM, act, dtype),
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

    def forward(self, grid: torch.Tensor, other: torch.Tensor):
        """(B, C, H, W) grid + (B, F) extras -> (B, A) policy logits,
        (B, NUM_VALUE_ATOMS) value logits, both float32."""
        x = grid.to(self.dtype)
        for i in range(self.n_conv_blocks):
            x = getattr(self, f"ConvBlock_{i}")(x)
        for i in range(self.n_res):
            x = getattr(self, f"ResidualBlock_{i}")(x)
        if self.use_transformer:
            if self.project:
                x = self.Conv_0(x)
            b, d = x.shape[0], x.shape[1]
            tokens = x.permute(0, 2, 3, 1).reshape(b, -1, d)  # NHWC token order
            tokens = tokens + self.positional
            for i in range(self.n_layers):
                tokens = getattr(self, f"TransformerEncoderLayer_{i}")(tokens)
            flat = self.LayerNorm_0(tokens).reshape(b, -1)
        else:
            flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        shared = torch.cat([flat, other.to(self.dtype)], dim=-1)
        for i in range(self.n_shared):
            shared = self.act(getattr(self, f"_Norm_{i}")(getattr(self, f"Dense_{i}")(shared)))
        policy = self.MLPHead_0(shared)
        value = self.MLPHead_1(shared)
        return policy.float(), value.float()


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
