"""Shared helpers of the `tests/test_torch_*.py` parity tests: moving
states, keys and weights between the JAX package and its PyTorch port,
a small model of the port's own, and an exact stub net for both."""

import contextlib
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphatriangle_tpu import compile_cache
from alphatriangle_tpu.config import ModelConfig, expected_other_features_dim
from alphatriangle_tpu_torch import config as tcfg
from alphatriangle_tpu_torch.config import PersistenceConfig
from alphatriangle_tpu_torch.env.engine import EnvState
from alphatriangle_tpu_torch.nn import flax_to_torch
from alphatriangle_tpu_torch.nn.network import LiveWeights

CPU = "cpu"

# A bfloat16 forward against another (either framework's, or the f32
# one): the tolerance `tests/test_ops.py::TestInferencePrecision` holds
# the JAX package's own bf16 path to. Policy probabilities within 0.05,
# expected values within 0.2 absolute plus 0.1 relative (bf16 keeps 8
# bits of mantissa, and the frameworks round at other places).
BF16_PROB_ATOL = 0.05
BF16_VALUE_ATOL, BF16_VALUE_RTOL = 0.2, 0.1


@pytest.fixture(autouse=True)
def plain_jax_programs(monkeypatch):
    """Run the JAX references of a test through plain `jax.jit`, with a
    process cache of its own that is disabled, restored after the test.

    With the suite's 8 virtual CPU devices, an executable that
    `jax.experimental.serialize_executable.deserialize_and_load` reloads
    expects one shard per device, and its first call with single-device
    arguments raises "Expected args to execute_sharded_on_local_devices
    to have 8 shards". The JAX package's `CompileCache` serializes every
    program it compiles into one directory per process and reloads it
    the next time a new engine, trainer or service of the same configs
    asks for the same program. So a parity test failed whenever an
    earlier test in its worker process (`tests/test_torch_stats.py`,
    for one) had compiled a program of the same configs, and passed
    when it ran first. Imported into a test module, this autouse
    fixture applies to each of its tests. The port's kernel build cache
    gets fresh accounts with its record capture off, as the JAX cache's
    is, so a port run's ledger holds the program records the JAX run's
    does (none).

    It also gives each test both packages' device-stats state at its
    defaults (stat-packs off, beacons unarmed, no beacon ledger), and
    leaves the port's at its defaults after it (`default_device_stats`):
    training setup publishes the stat-pack flag for the rest of its
    process, and a search reads it when it is built, so otherwise a
    test, or a module-scoped fixture built before the next test, would
    see whatever an earlier test in its worker left."""
    monkeypatch.setattr(compile_cache, "_global_cache", compile_cache.CompileCache(enabled=False))
    from alphatriangle_tpu_torch import compile_cache as port_cache

    monkeypatch.setattr(port_cache, "_global_cache", port_cache.BuildCache(enabled=False))
    from alphatriangle_tpu.telemetry import device_stats as jds

    for name in ("_device_stats", "_beacons_armed", "_beacon_every", "_beacon_ledger",
                 "_current_program"):
        monkeypatch.setattr(jds, name, None)
    default_device_stats()
    yield
    from alphatriangle_tpu_torch.ops import beacon

    beacon.stop_all()
    default_device_stats()


def default_device_stats() -> None:
    """The port's device-stats state back at its import-time defaults
    (stat-packs as the environment says, beacons unarmed, no beacon
    ledger). Module-scoped fixtures that build a port search call it
    first; a test module that runs training setup in its own process and
    does not import `plain_jax_programs` calls it after each test
    (`reset_device_stats`)."""
    from alphatriangle_tpu_torch.telemetry.device_stats import reset_device_stats_state

    reset_device_stats_state()


@pytest.fixture(autouse=True)
def reset_device_stats():
    """Autouse where imported: into a test module that runs training setup in-process
    (which publishes the stat-pack flag for the process) without
    importing `plain_jax_programs`: each test leaves the flag at its
    default."""
    yield
    default_device_stats()


def torch_cfg(jax_cfg):
    """The port's counterpart of a JAX config, loaded from its dump."""
    cls = getattr(tcfg, type(jax_cfg).__name__)
    return cls(**jax_cfg.model_dump())


def run_root(tmp_path, run: str = "run") -> PersistenceConfig:
    """A run directory of the port under `tmp_path`, so a test that builds
    training components writes nothing into the checkout."""
    return PersistenceConfig(ROOT_DATA_DIR=str(tmp_path), RUN_NAME=run)


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


def dense_rows(
    seed: int, n: int, grid_shape, other_dim: int, action_dim: int,
    nonfinite: bool = False, not_a_policy: bool = False,
) -> dict:
    """`add_dense` keyword arguments of `n` random rows (NumPy); with
    `nonfinite`, one row holds an inf and one a NaN; with `not_a_policy`,
    one policy row does not sum to 1."""
    pick = np.random.default_rng(seed)
    policy = pick.random((n, action_dim)).astype(np.float32) ** 3
    policy /= policy.sum(-1, keepdims=True)
    rows = {
        "grid": pick.integers(-1, 2, (n, *grid_shape)).astype(np.float32),
        "other_features": pick.random((n, other_dim)).astype(np.float32),
        "policy_target": policy,
        "value_target": (pick.normal(size=n) * 4).astype(np.float32),
        "policy_weight": (pick.random(n) < 0.8).astype(np.float32),
    }
    if nonfinite:
        rows["value_target"][1] = np.inf
        rows["other_features"][n // 2, 0] = np.nan
    if not_a_policy:
        rows["policy_target"][n - 1] *= 2.0
    return rows


def assert_params_close(model, jax_params, lr: float, steps: int, rounding=None) -> None:
    """A torch module's parameters against a Flax params tree after
    `steps` Adam steps of learning rate `lr` from the same start: within
    1e-3 of lr per step, apart from at most 1% of entries whose gradient
    was rounding-sized (Adam moves those by ~lr in either sign). The
    entries `rounding` marks (`rounding_sized`) are held to Adam's bound
    only."""
    want = flax_to_torch({"params": jax.tree_util.tree_map(np.asarray, jax_params)})
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        assert diff.max() <= 2 * lr * steps, (name, diff.max())
        if rounding is not None:
            diff = diff[~rounding[name]]
        if diff.size:
            assert (diff > 1e-3 * lr * steps).mean() <= 0.01, (name, diff.max())


def jax_adam_moments(jopt_state) -> tuple[dict, dict, int]:
    """The (mu, nu, count) of the ScaleByAdamState in a JAX optax chain,
    the moments under the port's parameter names."""
    import optax

    adam = next(s for s in jax.tree_util.tree_leaves(
        jopt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)
    ) if isinstance(s, optax.ScaleByAdamState))
    mu, nu = (
        flax_to_torch({"params": jax.tree_util.tree_map(np.asarray, t)}) for t in (adam.mu, adam.nu)
    )
    return mu, nu, int(adam.count)


ROUNDING_RMS = 1e-5  # of the net's largest gradient RMS


def rounding_sized(nu: dict) -> dict:
    """name -> mask of the entries whose gradient is rounding noise: its
    RMS over the steps (the square root of Adam's `nu`) at most
    `ROUNDING_RMS` of the net's largest. Under batch norm these are the
    biases a norm follows (the norm subtracts them with the batch mean)
    and the weights of inputs that are constant over the batch; their
    gradients sit near 1e-7 of the largest, every other entry's above
    1e-5 (the megastep and learner tests' nets)."""
    top = max(float(np.sqrt(v.numpy()).max()) for v in nu.values())
    return {n: np.sqrt(v.numpy()) <= ROUNDING_RMS * top for n, v in nu.items()}


def stub_net(model, support, version: int = 3) -> SimpleNamespace:
    """A stand-in for the port's `NeuralNetwork` around a stub model:
    the weights a chunk reads (`live`) at weights version `version`,
    read at float32 (`inference_model` gives the model itself)."""
    live = LiveWeights(version, model)
    return SimpleNamespace(
        model=model, support=support, weights_version=version, live=live,
        inference_model=lambda weights=None: (weights or live).model,
    )


def inject_jax_noise(monkeypatch) -> None:
    """Route the port's Gumbel and gamma draws through `jax.random` for
    the same key, so a search sees exactly the JAX package's noise."""
    from alphatriangle_tpu_torch import rng

    def rows(draws, lanes, device, key):
        """A dp rank's rows (`lanes`) of a draw over the global lane array."""
        if lanes is not None:
            draws = draws[lanes.lo: lanes.hi]
        return torch.from_numpy(draws.copy()).to(device or key.device)

    def full(shape, lanes):
        return tuple(shape) if lanes is None else (lanes.total, *tuple(shape)[1:])

    def gumbel(key, shape, device=None, lanes=None):
        return rows(np.asarray(jax.random.gumbel(jax_key(key), full(shape, lanes))), lanes, device, key)

    def gamma(key, alpha, shape, device=None, lanes=None):
        draws = np.asarray(jax.random.gamma(jax_key(key), alpha, shape=full(shape, lanes)))
        return rows(draws, lanes, device, key)

    monkeypatch.setattr(rng, "gumbel", gumbel)
    monkeypatch.setattr(rng, "gamma", gamma)


def tiny_preset(path, env_cfg, model_cfg, **train) -> str:
    """A tuned-preset artifact of the given (JAX) board and net, the default
    train config with `train` on top and a 4-simulation search, for `cli
    train --preset PATH` runs that take seconds on the CPU. Returns its
    path."""
    from alphatriangle_tpu.config import AlphaTriangleMCTSConfig as JaxMCTSConfig

    payload = {
        "schema": tcfg.TUNED_PRESET_SCHEMA,
        "configs": {
            "env": env_cfg.model_dump(),
            "model": model_cfg.model_dump(),
            "train": tcfg.TrainConfig(**train).model_dump(),
            "mcts": JaxMCTSConfig(max_simulations=4, max_depth=3, mcts_batch_size=4).model_dump(),
        },
    }
    path = Path(path)
    path.write_text(json.dumps(payload))
    return str(path)


# Stat-packs against JAX's: the depth histogram and |value| maximum
# exactly; the means over B <= 8 games within 1e-6 relative (XLA's CPU
# mean is a float32 sum in order times float32(1/B), off by at most B
# roundings of 2^-24; the port's float64 mean of the same float32 values
# is exact); the root entropy within 1e-6 relative (a log and a sum in
# each framework's order).
STAT_RTOL = 1e-6


@contextlib.contextmanager
def device_stats_on():
    """Both packages' stat-pack flag on while engines are built inside
    the block (engines read it when built); the old values after it."""
    from alphatriangle_tpu.telemetry import device_stats as jds
    from alphatriangle_tpu_torch.telemetry import device_stats as tds

    saved = [(mod, mod._device_stats) for mod in (jds, tds)]
    for mod, _ in saved:
        mod.set_device_stats(True)
    try:
        yield
    finally:
        for mod, value in saved:
            mod._device_stats = value


def assert_stat_packs(tpacks, jstats, msg: str = "") -> None:
    """The port's (..., SEARCH_PACK_SIZE) stat-packs against the JAX
    stat-pack leaves of the same searches."""
    from alphatriangle_tpu_torch.telemetry.device_stats import unpack_search_stats

    got = unpack_search_stats(tpacks.numpy() if isinstance(tpacks, torch.Tensor) else tpacks)
    want = jax.device_get(jstats)
    assert set(got) == set(want), msg
    for key in ("depth_hist", "value_abs_max"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key], np.float64), err_msg=f"{msg} {key}")
    for key in ("root_concentration", "occupancy", "reuse_frac", "root_entropy"):
        np.testing.assert_allclose(
            got[key], np.asarray(want[key]), rtol=STAT_RTOL, atol=0, err_msg=f"{msg} {key}"
        )


# --- CPU data-parallel ranks (tests/torch_dp_rank.py) -------------------

_ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 120


def spawn_ranks(spec: dict, tmp_path, world: int = 2) -> tuple:
    """Start `world` gloo rank processes of `tests/torch_dp_rank.py` on
    `spec` (its store and output paths filled in under `tmp_path`), one
    thread each; returns (processes, output directory). The parent
    computes its JAX reference while they run."""
    import os
    import subprocess
    import sys

    out = Path(tmp_path) / "ranks"
    out.mkdir(parents=True, exist_ok=True)
    spec = dict(spec, world=world, store=str(out / "store"), out=str(out))
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(_ROOT))
    procs = [
        subprocess.Popen(
            [sys.executable, str(_ROOT / "tests" / "torch_dp_rank.py"), str(spec_path), str(r)],
            cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(world)
    ]
    return procs, out


def collect_ranks(procs, out) -> list:
    """Wait for the ranks and load each one's results (rank order)."""
    import subprocess

    results = []
    for r, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        assert proc.returncode == 0, f"rank {r} exited {proc.returncode}:\n{err[-4000:]}"
        results.append(torch.load(Path(out) / f"rank{r}.pt", weights_only=False))
    return results


def assert_params_within(state: dict, jax_params, rounding: dict, lr: float, steps: int,
                         rtol: float = 2e-4, atol: float = 2e-5) -> None:
    """A port state dict's parameters against a Flax params tree within
    `rtol`/`atol` (the JAX dp test's tolerance), apart from the entries
    `rounding` marks (`rounding_sized`), which Adam may move by ~lr in
    either sign and are held to its bound only."""
    want = flax_to_torch({"params": jax.tree_util.tree_map(np.asarray, jax_params)})
    for name, ref in want.items():
        got = state[name].numpy()
        ref = ref.numpy()
        mask = rounding.get(name, np.zeros(ref.shape, bool))
        np.testing.assert_allclose(got[~mask], ref[~mask], rtol=rtol, atol=atol, err_msg=name)
        assert np.abs(got[mask] - ref[mask]).max(initial=0.0) <= 2 * lr * steps, name
