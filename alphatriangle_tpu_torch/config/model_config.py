"""Neural-network architecture configuration: counterpart of
`alphatriangle_tpu/config/model_config.py`, field for field.

`COMPUTE_DTYPE="bfloat16"` (the default) runs the trunk in bf16 with
f32 parameters, f32 norm statistics and f32 head outputs, as the JAX
model does.
"""

from dataclasses import dataclass, field
from typing import Any

from ._base import ConfigBase, check_choice, check_range

ACTIVATIONS = ("ReLU", "GELU", "SiLU", "Tanh", "Sigmoid")
NORM_TYPES = ("group", "layer", "batch", "none")


@dataclass
class ModelConfig(ConfigBase):
    """Policy/value network hyperparameters."""

    GRID_INPUT_CHANNELS: int = 1
    CONV_FILTERS: list[int] = field(default_factory=lambda: [32, 64, 128])
    CONV_KERNEL_SIZES: list[int] = field(default_factory=lambda: [3, 3, 3])
    CONV_STRIDES: list[int] = field(default_factory=lambda: [1, 1, 1])
    NUM_RESIDUAL_BLOCKS: int = 2
    RESIDUAL_BLOCK_FILTERS: int = 128
    USE_TRANSFORMER: bool = True
    TRANSFORMER_DIM: int = 128
    TRANSFORMER_HEADS: int = 4
    TRANSFORMER_LAYERS: int = 2
    TRANSFORMER_FC_DIM: int = 256
    FC_DIMS_SHARED: list[int] = field(default_factory=lambda: [128])
    POLICY_HEAD_DIMS: list[int] = field(default_factory=lambda: [128])
    VALUE_HEAD_DIMS: list[int] = field(default_factory=lambda: [128])
    NUM_VALUE_ATOMS: int = 51
    VALUE_MIN: float = -10.0
    VALUE_MAX: float = 10.0
    ACTIVATION_FUNCTION: str = "ReLU"
    NORM_TYPE: str = "group"
    OTHER_NN_INPUT_FEATURES_DIM: int = 30
    COMPUTE_DTYPE: str = "bfloat16"
    PARAM_DTYPE: str = "float32"
    # Kept so a dumped JAX config loads; the port runs no rematerialization.
    REMAT: bool = False
    INFERENCE_PRECISION: str = "float32"

    def __post_init__(self) -> None:
        check_range("GRID_INPUT_CHANNELS", self.GRID_INPUT_CHANNELS, gt=0)
        check_range("NUM_RESIDUAL_BLOCKS", self.NUM_RESIDUAL_BLOCKS, ge=0)
        check_range("RESIDUAL_BLOCK_FILTERS", self.RESIDUAL_BLOCK_FILTERS, gt=0)
        check_range("TRANSFORMER_DIM", self.TRANSFORMER_DIM, gt=0)
        check_range("TRANSFORMER_HEADS", self.TRANSFORMER_HEADS, gt=0)
        check_range("TRANSFORMER_LAYERS", self.TRANSFORMER_LAYERS, ge=0)
        check_range("TRANSFORMER_FC_DIM", self.TRANSFORMER_FC_DIM, gt=0)
        check_range("NUM_VALUE_ATOMS", self.NUM_VALUE_ATOMS, gt=1)
        check_range(
            "OTHER_NN_INPUT_FEATURES_DIM", self.OTHER_NN_INPUT_FEATURES_DIM, gt=0
        )
        check_choice("ACTIVATION_FUNCTION", self.ACTIVATION_FUNCTION, ACTIVATIONS)
        check_choice("NORM_TYPE", self.NORM_TYPE, NORM_TYPES)
        check_choice("COMPUTE_DTYPE", self.COMPUTE_DTYPE, ("bfloat16", "float32"))
        check_choice("PARAM_DTYPE", self.PARAM_DTYPE, ("float32",))
        check_choice(
            "INFERENCE_PRECISION",
            self.INFERENCE_PRECISION,
            ("float32", "bfloat16", "int8"),
        )
        n = len(self.CONV_FILTERS)
        if len(self.CONV_KERNEL_SIZES) != n or len(self.CONV_STRIDES) != n:
            raise ValueError(
                "CONV_FILTERS, CONV_KERNEL_SIZES and CONV_STRIDES must have "
                "matching lengths."
            )
        if self.USE_TRANSFORMER and self.TRANSFORMER_LAYERS > 0:
            if self.TRANSFORMER_DIM % self.TRANSFORMER_HEADS != 0:
                raise ValueError(
                    f"TRANSFORMER_DIM ({self.TRANSFORMER_DIM}) must be divisible "
                    f"by TRANSFORMER_HEADS ({self.TRANSFORMER_HEADS})."
                )
        if self.VALUE_MIN >= self.VALUE_MAX:
            raise ValueError("VALUE_MIN must be strictly less than VALUE_MAX.")

    @property
    def USE_BATCH_NORM(self) -> bool:
        """Alias for the reference knob, derived from NORM_TYPE."""
        return self.NORM_TYPE == "batch"

    @classmethod
    def model_validate(cls, data: dict[str, Any]) -> "ModelConfig":
        # Accept the reference's USE_BATCH_NORM kwarg by mapping it onto
        # NORM_TYPE (an explicit NORM_TYPE wins), as the JAX model does.
        if "USE_BATCH_NORM" in data:
            data = dict(data)
            use_bn = data.pop("USE_BATCH_NORM")
            data.setdefault("NORM_TYPE", "batch" if use_bn else "none")
        return cls(**data)
