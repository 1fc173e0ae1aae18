"""Analytic FLOP accounting: counterpart of `alphatriangle_tpu/utils/
flops.py`'s `forward_flops`, `train_step_flops` and
`peak_bf16_tflops_info`.

`forward_flops` turns a ModelConfig and EnvConfig into the matmul and
conv FLOPs of one forward pass of one example (1 MAC = 2 FLOPs; norms,
activations and elementwise adds are left out); `train_step_flops` is
one learner step on a batch. The peak table keys a device by the name
`torch.cuda.get_device_name` gives it: the H100 variants at NVIDIA's
published dense bf16 peaks, beside the JAX package's TPU entries. A
device the table does not know reads `"unknown"`, its peak None and its
MFU null, unless the operator sets `ALPHATRIANGLE_PEAK_TFLOPS`. Imports
neither torch nor the configs.
"""

import logging
import os

logger = logging.getLogger(__name__)

# Operator-supplied peak override: the denominator is then whatever the
# operator declares, recorded as peak_source="env".
PEAK_TFLOPS_ENV = "ALPHATRIANGLE_PEAK_TFLOPS"


def _conv2d_flops(h: int, w: int, cin: int, cout: int, k: int, s: int) -> int:
    """SAME-padded k x k conv at stride s over (h, w): 2*HWK^2*Cin*Cout."""
    ho = -(-h // s)
    wo = -(-w // s)
    return 2 * ho * wo * k * k * cin * cout


def forward_flops(model, env, action_dim: int) -> int:
    """Matmul/conv FLOPs of ONE forward pass of `AlphaTriangleNet`
    (nn/model.py) for ONE example."""
    h, w = env.ROWS, env.COLS
    total = 0

    # Conv trunk.
    cin = model.GRID_INPUT_CHANNELS
    for f, k, s in zip(
        model.CONV_FILTERS, model.CONV_KERNEL_SIZES, model.CONV_STRIDES
    ):
        total += _conv2d_flops(h, w, cin, f, k, s)
        h, w = -(-h // s), -(-w // s)
        cin = f

    # Residual stack (+ 1x1 adapter when widths differ).
    if model.NUM_RESIDUAL_BLOCKS > 0:
        rf = model.RESIDUAL_BLOCK_FILTERS
        if cin != rf:
            total += _conv2d_flops(h, w, cin, rf, 1, 1)
            cin = rf
        total += model.NUM_RESIDUAL_BLOCKS * 2 * _conv2d_flops(
            h, w, rf, rf, 3, 1
        )

    # Transformer over the S = h*w token sequence.
    if model.USE_TRANSFORMER and model.TRANSFORMER_LAYERS > 0:
        d = model.TRANSFORMER_DIM
        if cin != d:
            total += _conv2d_flops(h, w, cin, d, 1, 1)
            cin = d
        s_len = h * w
        per_layer = (
            4 * 2 * s_len * d * d  # Q, K, V, out projections
            + 2 * 2 * s_len * s_len * d  # QK^T and attn @ V
            + 2 * 2 * s_len * d * model.TRANSFORMER_FC_DIM  # MLP in + out
        )
        total += model.TRANSFORMER_LAYERS * per_layer

    # Heads over the flattened features (+ the auxiliary scalar input).
    flat = h * w * cin + model.OTHER_NN_INPUT_FEATURES_DIM
    dim = flat
    for fc in model.FC_DIMS_SHARED:
        total += 2 * dim * fc
        dim = fc
    for dims, out in (
        (model.POLICY_HEAD_DIMS, action_dim),
        (model.VALUE_HEAD_DIMS, model.NUM_VALUE_ATOMS),
    ):
        hd = dim
        for fc in dims:
            total += 2 * hd * fc
            hd = fc
        total += 2 * hd * out
    return total


def train_step_flops(model, env, action_dim: int, batch: int) -> int:
    """Matmul FLOPs of one SGD step on a `batch`: forward + ~2x
    backward (+1x forward recompute under REMAT)."""
    mult = 4 if model.REMAT else 3
    return mult * batch * forward_flops(model, env, action_dim)


# Peak dense bf16 matmul throughput per device, TFLOP/s, without
# sparsity. NVIDIA's published H100 figures by `torch.cuda.get_device_name`
# (SXM5 989.4, PCIe 756, NVL 835); the TPU chips' public figures, v4 275,
# v5e (v5 lite) 394, v5p 459, v6e (Trillium) 918. No H100 key is a
# prefix of another, so the longest-prefix fallback cannot cross them.
_PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4,
    "NVIDIA H100 PCIe": 756.0,
    "NVIDIA H100 NVL": 835.0,
    "TPU v4": 275.0,
    "TPU v5 lite": 394.0,
    "TPU v5e": 394.0,
    "TPU v5": 459.0,
    "TPU v5p": 459.0,
    "TPU v6 lite": 918.0,
    "TPU v6e": 918.0,
}


def peak_bf16_tflops_info(device_kind: str) -> tuple[float | None, str]:
    """(peak bf16 TFLOP/s, source) for a device kind (a CUDA device's
    `torch.cuda.get_device_name`).

    Source is "env" (ALPHATRIANGLE_PEAK_TFLOPS override — wins so
    operators can assert a denominator for unlisted chips or CPU
    smokes), "table" (known chip), or "unknown" (peak None — an
    explicit marker, never a guessed denominator).
    """
    override = os.environ.get(PEAK_TFLOPS_ENV, "").strip()
    if override:
        try:
            value = float(override)
            if value > 0:
                return value, "env"
            logger.warning(
                "%s=%r is not positive; ignoring.", PEAK_TFLOPS_ENV, override
            )
        except ValueError:
            logger.warning(
                "%s=%r is not a number; ignoring.", PEAK_TFLOPS_ENV, override
            )
    kind = (device_kind or "").strip()
    if kind in _PEAK_BF16_TFLOPS:
        return _PEAK_BF16_TFLOPS[kind], "table"
    # Longest-prefix fallback, space-insensitive: device kinds vary
    # across runtime versions ("TPU v5 lite" vs "TPU v5litepod-8").
    norm = kind.lower().replace(" ", "")
    best = None
    for name, peak in _PEAK_BF16_TFLOPS.items():
        key = name.lower().replace(" ", "")
        if norm.startswith(key) and (best is None or len(key) > best[0]):
            best = (len(key), peak)
    if best:
        return best[1], "table"
    return None, "unknown"
