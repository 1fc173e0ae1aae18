"""Shared helpers of the `tests/test_torch_*.py` parity tests: moving
states, keys and weights between the JAX package and its PyTorch port,
a small model of the port's own, and an exact stub net for both."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alphatriangle_tpu.config import ModelConfig, expected_other_features_dim
from alphatriangle_tpu_torch import config as tcfg
from alphatriangle_tpu_torch.env.engine import EnvState
from alphatriangle_tpu_torch.nn import flax_to_torch

CPU = "cpu"


def torch_cfg(jax_cfg):
    """The port's counterpart of a JAX config, loaded from its dump."""
    cls = getattr(tcfg, type(jax_cfg).__name__)
    return cls(**jax_cfg.model_dump())


def to_torch_state(jstate) -> EnvState:
    """A (batched) JAX EnvState as the port's EnvState on the CPU;
    uint32 words become int64."""
    fields = {}
    for name in EnvState.__dataclass_fields__:
        arr = np.asarray(getattr(jstate, name))
        if arr.dtype == np.uint32:
            arr = arr.astype(np.int64)
        fields[name] = torch.from_numpy(arr.copy())
    return EnvState(**fields)


def jax_key(key: torch.Tensor) -> jax.Array:
    """A port key (int64 words) as a raw JAX threefry key."""
    return jnp.asarray(key.cpu().numpy().astype(np.uint32))


def torch_key(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def small_model_config(env_cfg, **overrides) -> ModelConfig:
    """A narrow net with every converter path: two conv blocks, a
    residual block, a channel projection, a transformer layer and two
    heads. Hidden widths of 64 keep GroupNorm's groups at 8 features:
    a group of 2 can hold two nearly equal values, whose variance is
    then all rounding, and the two frameworks' roundings differ."""
    fields = dict(
        GRID_INPUT_CHANNELS=1,
        CONV_FILTERS=[16, 16],
        CONV_KERNEL_SIZES=[3, 1],
        CONV_STRIDES=[1, 1],
        NUM_RESIDUAL_BLOCKS=1,
        RESIDUAL_BLOCK_FILTERS=16,
        USE_TRANSFORMER=True,
        TRANSFORMER_DIM=12,
        TRANSFORMER_HEADS=2,
        TRANSFORMER_LAYERS=1,
        TRANSFORMER_FC_DIM=16,
        FC_DIMS_SHARED=[64],
        POLICY_HEAD_DIMS=[64],
        VALUE_HEAD_DIMS=[64],
        NUM_VALUE_ATOMS=11,
        OTHER_NN_INPUT_FEATURES_DIM=expected_other_features_dim(env_cfg),
        COMPUTE_DTYPE="float32",
        NORM_TYPE="group",
    )
    fields.update(overrides)
    return ModelConfig(**fields)


def converted_state_dict(jax_net) -> dict:
    """`flax_to_torch` of a JAX NeuralNetwork's variables."""
    return flax_to_torch(jax.tree_util.tree_map(np.asarray, jax_net.variables))


def _stub_atom(count, atoms: int):
    return (count * 3 + 1) % atoms


class JaxExactStub:
    """A stand-in for the JAX net whose outputs are exact: zero policy
    logits and value logits that put all mass on one atom, chosen from
    the number of occupied cells."""

    def __init__(self, action_dim: int, atoms: int):
        self.action_dim, self.atoms = action_dim, atoms

    def apply(self, variables, grid, other, train=False):
        count = jnp.clip(grid[:, 0], 0.0, None).sum(axis=(-2, -1)).astype(jnp.int32)
        onehot = jax.nn.one_hot(_stub_atom(count, self.atoms), self.atoms) > 0
        value = jnp.where(onehot, 0.0, -jnp.inf)
        return jnp.zeros((grid.shape[0], self.action_dim), jnp.float32), value


class TorchExactStub:
    """`JaxExactStub` for the port: `model(grid, other)`."""

    def __init__(self, action_dim: int, atoms: int):
        self.action_dim, self.atoms = action_dim, atoms

    def __call__(self, grid, other):
        count = grid[:, 0].clamp(min=0.0).sum(dim=(-2, -1)).to(torch.int64)
        onehot = torch.nn.functional.one_hot(_stub_atom(count, self.atoms), self.atoms) > 0
        value = torch.where(onehot, 0.0, float("-inf"))
        return torch.zeros((grid.shape[0], self.action_dim)), value


def inject_jax_noise(monkeypatch) -> None:
    """Route the port's Gumbel and gamma draws through `jax.random` for
    the same key, so a search sees exactly the JAX package's noise."""
    from alphatriangle_tpu_torch import rng

    def gumbel(key, shape, device=None):
        draws = np.asarray(jax.random.gumbel(jax_key(key), tuple(shape)))
        return torch.from_numpy(draws.copy()).to(device or key.device)

    def gamma(key, alpha, shape, device=None):
        draws = np.asarray(jax.random.gamma(jax_key(key), alpha, shape=tuple(shape)))
        return torch.from_numpy(draws.copy()).to(device or key.device)

    monkeypatch.setattr(rng, "gumbel", gumbel)
    monkeypatch.setattr(rng, "gamma", gamma)
