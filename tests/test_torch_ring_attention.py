"""Parity of the port's sequence-parallel attention
(`parallel/ring_attention.py`) with the JAX package's.

- Ring and Ulysses on gloo ranks (`tests/torch_dp_rank.py`, no JAX) at
  sp = 2 and 4: each rank's output and its q / k / v gradients for a
  given output gradient against the JAX `make_sp_attention` (its
  `ring_attention` / `ulysses_attention` under `shard_map`) and against
  dense attention, at `tests/test_ring_attention.py`'s tolerances
  (forward 2e-5, gradients 5e-5, relative and absolute); the port's
  `attention_fn` on the whole inputs (slice, attend, gather) likewise.
- The small model with the sp core (ring and Ulysses, sp = 2) against
  the JAX model with `make_sp_attention`: logits within 2e-5.
- Every refusal with JAX's message: an unknown kind, a bias or a mask,
  attention-weight dropout in train mode, Ulysses heads that do not
  divide by sp; and the dense path when the sequence does not divide.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alphatriangle_tpu.config import MeshConfig as JaxMeshConfig  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.parallel.ring_attention import _dense_attention as jax_dense  # noqa: E402
from alphatriangle_tpu.parallel.ring_attention import make_sp_attention as jax_sp_attention  # noqa: E402
from alphatriangle_tpu_torch.config.mesh_config import Mesh  # noqa: E402
from alphatriangle_tpu_torch.parallel.ring_attention import make_sp_attention  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import (  # noqa: E402
    collect_ranks,
    converted_state_dict,
    small_model_config,
    spawn_ranks,
)

FWD_TOL = 2e-5
GRAD_TOL = 5e-5
B, S, H, D = 2, 8, 4, 8


def _qkv(seed: int = 0) -> dict:
    pick = np.random.default_rng(seed)
    return {k: pick.normal(size=(B, S, H, D)).astype(np.float32) for k in ("q", "k", "v", "dout")}


def _jax_reference(arrays: dict, n: int, kind: "str | None") -> dict:
    """The JAX attention (sequence-parallel over n devices, or dense)
    and its gradients for `dout`."""
    if kind is None:
        def fn(q, k, v):
            return jax_dense(q, k, v, 1.0 / np.sqrt(D))
    else:
        mesh = JaxMeshConfig(DP_SIZE=1, SP_SIZE=n).build_mesh(jax.devices()[:n])
        fn = jax_sp_attention(mesh, kind=kind, dp_axis=None)
    def run(q, k, v, dout):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(dout))

    got = jax.jit(run)(*(jnp.asarray(arrays[x]) for x in ("q", "k", "v", "dout")))
    return {name: np.asarray(t) for name, t in zip(("out", "dq", "dk", "dv"), got)}


@pytest.mark.parametrize("n", [2, 4])
def test_ring_and_ulysses_match_jax_and_dense(tmp_path, n):
    arrays = _qkv(n)
    np.savez(tmp_path / "qkv.npz", **arrays)
    procs, out = spawn_ranks(
        {"scenario": "sp_attention", "mesh": {"SP_SIZE": n}, "qkv": str(tmp_path / "qkv.npz")},
        tmp_path, world=n,
    )
    dense = _jax_reference(arrays, n, None)
    refs = {kind: _jax_reference(arrays, n, kind) for kind in ("ring", "ulysses")}
    ranks = collect_ranks(procs, out)
    for kind, ref in refs.items():
        for want in (ref, dense):
            for r, got in enumerate(ranks):
                for name, tol in (("out", FWD_TOL), ("dq", GRAD_TOL), ("dk", GRAD_TOL), ("dv", GRAD_TOL)):
                    # A rank holds its sequence shard of each.
                    np.testing.assert_allclose(
                        got[kind][name].numpy(), np.split(want[name], n, axis=1)[r], rtol=tol, atol=tol,
                        err_msg=f"{kind} rank {r} {name}",
                    )
                    # The attention_fn: whole inputs, whole outputs and gradients.
                    np.testing.assert_allclose(
                        got[f"{kind}_fn"][name].numpy(), want[name], rtol=tol, atol=tol,
                        err_msg=f"{kind} attention_fn rank {r} {name}",
                    )
    for kind in ("ring_fn", "ulysses_fn"):
        for name in ("out", "dq", "dk", "dv"):
            # Every sp rank ends with the same whole tensors.
            assert all(torch.equal(ranks[0][kind][name], rk[kind][name]) for rk in ranks), (kind, name)


def test_sp_model_matches_jax_model(tmp_path, tiny_env_config):
    """The small net (12 tokens, 2 heads) with the sp core at sp = 2
    against the JAX net with `make_sp_attention`, in eval mode."""
    model_cfg = small_model_config(tiny_env_config)
    jnet = JaxNetwork(model_cfg, tiny_env_config, seed=3)
    torch.save(converted_state_dict(jnet), tmp_path / "net.pt")
    pick = np.random.default_rng(5)
    grid = pick.integers(-1, 2, (4, 1, tiny_env_config.ROWS, tiny_env_config.COLS)).astype(np.float32)
    other = pick.random((4, model_cfg.OTHER_NN_INPUT_FEATURES_DIM)).astype(np.float32)
    np.savez(tmp_path / "batch.npz", grid=grid, other=other)
    procs, out = spawn_ranks(
        {"scenario": "sp_model", "mesh": {"SP_SIZE": 2}, "env": tiny_env_config.model_dump(),
         "model": model_cfg.model_dump(), "train": {}, "state_dict": str(tmp_path / "net.pt"),
         "batch": str(tmp_path / "batch.npz")},
        tmp_path,
    )
    mesh = JaxMeshConfig(DP_SIZE=1, SP_SIZE=2).build_mesh(jax.devices()[:2])
    want = {}
    for kind in ("ring", "ulysses"):
        jsp = JaxNetwork(model_cfg, tiny_env_config, seed=3, variables=jnet.variables,
                         attention_fn=jax_sp_attention(mesh, kind=kind, dp_axis=None))
        policy, value = jax.jit(lambda v, g, o, m=jsp.model: m.apply(v, g, o, train=False))(
            jnet.variables, jnp.asarray(grid), jnp.asarray(other))
        want[kind] = (np.asarray(policy), np.asarray(value))
    for r, got in enumerate(collect_ranks(procs, out)):
        for kind, (policy, value) in want.items():
            np.testing.assert_allclose(got[kind]["policy"].numpy(), policy, rtol=2e-5, atol=2e-5,
                                       err_msg=f"rank {r} {kind} policy")
            np.testing.assert_allclose(got[kind]["value"].numpy(), value, rtol=2e-5, atol=2e-5,
                                       err_msg=f"rank {r} {kind} value")


def _jax_error(fn) -> "tuple[type, str]":
    try:
        fn()
    except Exception as exc:  # the JAX package's own refusal
        return type(exc), str(exc)
    raise AssertionError("the JAX attention did not refuse")


@pytest.mark.parametrize("case", ["kind", "bias", "mask", "dropout", "ulysses_heads"])
def test_refusals_match_jax(case):
    """Each refusal raises JAX's exception type and message (no group:
    the checks come before any collective)."""
    mesh = Mesh(sp=2)
    jmesh = JaxMeshConfig(DP_SIZE=1, SP_SIZE=2).build_mesh(jax.devices()[:2])
    x = np.zeros((B, S, 3 if case == "ulysses_heads" else H, D), np.float32)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    if case == "kind":
        want = _jax_error(lambda: jax_sp_attention(jmesh, kind="flash"))
        with pytest.raises(want[0]) as got:
            make_sp_attention(mesh, "flash")
    else:
        kind = "ulysses" if case == "ulysses_heads" else "ring"
        kw = {"bias": {"bias": 1}, "mask": {"mask": 1}, "dropout": {"dropout_rate": 0.1, "deterministic": False},
              "ulysses_heads": {}}[case]
        jfn = jax_sp_attention(jmesh, kind=kind, dp_axis=None)
        want = _jax_error(lambda: jfn(j, j, j, **kw))
        with pytest.raises(want[0]) as got:
            make_sp_attention(mesh, kind)(t, t, t, **kw)
    assert str(got.value) == want[1]


def test_indivisible_sequence_attends_densely():
    """S = 7 over sp = 2: the dense arithmetic, without a collective."""
    pick = np.random.default_rng(1)
    q, k, v = (pick.normal(size=(B, 7, H, D)).astype(np.float32) for _ in range(3))
    got = make_sp_attention(Mesh(sp=2), "ring")(*(torch.from_numpy(a) for a in (q, k, v)))
    want = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1.0 / np.sqrt(D))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)
