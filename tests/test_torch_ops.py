"""Parity of the PyTorch port's ops (`alphatriangle_tpu_torch/ops/`) with
the JAX package's, all exact.

On the CPU every dispatcher runs its plain PyTorch version; these tests
hold it against each JAX lowering, the Pallas kernels in interpret mode
as `tests/test_ops.py` runs them. The hand-written CUDA kernels are held
against the plain versions on the card by `tests/test_torch_kernels.py`
and `chip_smoke.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from alphatriangle_tpu.ops import backup_update as jax_backup  # noqa: E402
from alphatriangle_tpu.ops import gather_rows as jax_gather  # noqa: E402
from alphatriangle_tpu.ops.mcts_backup import backup_update_pallas  # noqa: E402
from alphatriangle_tpu_torch.ops import KERNELS, backup_update, gather_rows  # noqa: E402


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


class TestGatherRows:
    @pytest.mark.parametrize("mode", ["einsum", "pallas", "take"])
    @pytest.mark.parametrize("shape", [(6, 17, 40, 5), (3, 9, 130, 4), (2, 65, 2160, 32)])
    def test_plain_matches_jax(self, mode, shape):
        b, n, k, w = shape
        pick = np.random.default_rng(k)
        stats = pick.standard_normal((b, n, k)).astype(np.float32)
        idx = pick.integers(0, n, (b, w)).astype(np.int32)
        want = np.asarray(jax_gather(jnp.asarray(stats), jnp.asarray(idx), mode))
        got = gather_rows(_t(stats), _t(idx).long(), mode=mode)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_unknown_mode_raises(self):
        with pytest.raises(ValueError, match="unknown gather"):
            gather_rows(torch.zeros((1, 2, 3)), torch.zeros((1, 1), dtype=torch.long), "cuda")

    def test_cpu_tensors_never_launch_the_kernel(self):
        before = KERNELS["gather_rows"].launches
        gather_rows(torch.zeros((1, 2, 3)), torch.zeros((1, 1), dtype=torch.long), "pallas")
        assert KERNELS["gather_rows"].launches == before


def _backup_inputs(seed: int, b=4, n=9, a=7, w=6, d=4):
    """Planes plus one wave's updates with forced duplicate edges (members
    sharing a parent and action) and inactive path entries."""
    pick = np.random.default_rng(seed)
    planes = (
        pick.integers(0, 5, (b, n, a)).astype(np.float32),
        pick.standard_normal((b, n, a)).astype(np.float32),
        np.where(pick.random((b, n, a)) < 0.3, pick.integers(1, n, (b, n, a)), -1).astype(
            np.float32
        ),
        pick.standard_normal((b, n, a)).astype(np.float32),
    )
    parents = pick.integers(0, 3, (b, w)).astype(np.int32)
    actions = pick.integers(0, 3, (b, w)).astype(np.int32)
    parents[:, 1::2], actions[:, 1::2] = parents[:, 0::2], actions[:, 0::2]
    new_child = np.where(pick.random((b, w)) < 0.5, pick.integers(1, n, (b, w)), -1.0)
    active = pick.random((b, w, d)) < 0.7
    active[:, :, 0] = True
    active[0, 0, :] = False  # a member with no active level
    rec_node = np.where(active, pick.integers(0, 3, (b, w, d)), -1).astype(np.int32)
    rec_action = np.where(active, pick.integers(0, 3, (b, w, d)), -1).astype(np.int32)
    rec_node[:, 2::3, 1] = rec_node[:, 0::3, 1][:, : rec_node[:, 2::3, 1].shape[1]]
    rec_action[:, 2::3, 1] = rec_action[:, 0::3, 1][:, : rec_action[:, 2::3, 1].shape[1]]
    return planes, (
        parents,
        actions,
        new_child.astype(np.float32),
        pick.standard_normal((b, w)).astype(np.float32),
        rec_node,
        rec_action,
        active,
        pick.standard_normal((b, w, d)).astype(np.float32),
    )


class TestBackupUpdate:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("jax_lowering", ["xla", "pallas-interpret"])
    def test_plain_matches_jax_bit_for_bit(self, seed, jax_lowering):
        planes, updates = _backup_inputs(seed)
        jargs = [jnp.asarray(x) for x in planes + updates]
        if jax_lowering == "xla":
            want = jax_backup(*jargs, mode="xla")
        else:
            want = backup_update_pallas(*jargs, interpret=True)
        tplanes = [_t(p.copy()) for p in planes]
        got = backup_update(*tplanes, *[_t(u) for u in updates], mode="pallas")
        for name, g, t, wnt in zip(
            ("e_visits", "e_value", "children", "e_reward"), got, tplanes, want, strict=True
        ):
            assert g is t, f"{name} is not updated in place"
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt), err_msg=name)

    def test_inactive_entries_add_nothing(self):
        planes, updates = _backup_inputs(5)
        updates = updates[:6] + (np.zeros_like(updates[6]),) + updates[7:]
        tplanes = [_t(p.copy()) for p in planes]
        visits, value, _, _ = backup_update(*tplanes, *[_t(u) for u in updates])
        np.testing.assert_array_equal(visits.numpy(), planes[0])
        np.testing.assert_array_equal(value.numpy(), planes[1])

    def test_unknown_mode_raises(self):
        planes, updates = _backup_inputs(0)
        with pytest.raises(ValueError, match="unknown backup"):
            backup_update(*[_t(p) for p in planes], *[_t(u) for u in updates], mode="x")
