"""Parity of the PyTorch port's replay layer with the JAX package:
the SumTree mirror, the host side of the buffer, `ring_scatter` and the
device ring, and the PER draw (`ops/per_sample.py`).

Everything here is exact: the SumTree is a NumPy copy, the ring writes
the same rows at the same slots, and the count `#{i : cum[i] < u}` is
compared on the JAX side's own cumsum and draws. Where the port computes
its own cumsum (`per_sample` end to end), the priorities are small
integers, whose prefix sums are exact in any order; only the
probabilities, which divide by a total summed in another order, carry a
tolerance of 1e-6 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.ops.per_sample import count_below_pallas, count_below_xla  # noqa: E402
from alphatriangle_tpu.ops.per_sample import per_sample as jax_per_sample  # noqa: E402
from alphatriangle_tpu.rl.buffer import ExperienceBuffer as JaxBuffer  # noqa: E402
from alphatriangle_tpu.rl.device_buffer import DeviceReplayBuffer as JaxRing  # noqa: E402
from alphatriangle_tpu.rl.device_buffer import ring_scatter as jax_ring_scatter  # noqa: E402
from alphatriangle_tpu.rl.types import SelfPlayResult as JaxResult  # noqa: E402
from alphatriangle_tpu.utils.sumtree import SumTree as JaxSumTree  # noqa: E402
from alphatriangle_tpu_torch.config import TrainConfig  # noqa: E402
from alphatriangle_tpu_torch.ops import KERNELS, count_below  # noqa: E402
from alphatriangle_tpu_torch.ops.kernel_cases import COUNT_CASES, count_case  # noqa: E402
from alphatriangle_tpu_torch.ops.per_sample import count_below_plain, per_sample  # noqa: E402
from alphatriangle_tpu_torch.rl import DeviceReplayBuffer, SelfPlayResult, ring_scatter  # noqa: E402
from alphatriangle_tpu_torch.rl.buffer import ExperienceBuffer  # noqa: E402
from alphatriangle_tpu_torch.utils.sumtree import SumTree  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import CPU, torch_cfg, torch_key  # noqa: E402

GRID, OTHER, ACTIONS = (1, 3, 4), 5, 12


def _train_cfg(**kw) -> JaxTrainConfig:
    base = dict(
        BATCH_SIZE=4, BUFFER_CAPACITY=24, MIN_BUFFER_SIZE_TO_TRAIN=8, USE_PER=True,
        PER_BETA_ANNEAL_STEPS=10, AUTO_RESUME_LATEST=False, RUN_NAME="replay",
    )
    base.update(kw)
    return JaxTrainConfig(**base)


def _blocks(seed: int, t: int = 3, b: int = 4, n: int = 2):
    """A rollout-shaped (mat, flush) pair as NumPy: random masks, a
    non-finite row and a policy row that is not a distribution."""
    pick = np.random.default_rng(seed)

    def block(lead):
        policy = pick.random(lead + (ACTIONS,)).astype(np.float32)
        policy /= policy.sum(-1, keepdims=True)
        out = {
            "grid": pick.integers(-1, 2, lead + GRID).astype(np.float32),
            "other": pick.random(lead + (OTHER,)).astype(np.float32),
            "policy": policy,
            "ret": pick.normal(size=lead).astype(np.float32),
            "pw": pick.integers(0, 2, lead).astype(np.float32),
            "mask": pick.random(lead) < 0.6,
        }
        return out

    mat, flush = block((t, b)), block((t, b, n))
    mat["mask"][0, :2] = True
    mat["other"][0, 0, 0] = np.nan  # dropped: non-finite
    mat["policy"][0, 1] *= 2.0  # dropped: not a distribution
    return mat, flush


def _to_torch(blocks):
    return tuple({k: torch.from_numpy(v.copy()) for k, v in b.items()} for b in blocks)


def _to_jax(blocks):
    return tuple({k: jnp.asarray(v) for k, v in b.items()} for b in blocks)


class TestSumTree:
    def test_ops_match_jax_exactly(self):
        pick = np.random.default_rng(0)
        ours, ref = SumTree(37), JaxSumTree(37)
        assert (ours._cap2, ours.max_priority) == (ref._cap2, ref.max_priority)
        for step in range(6):
            # Ring-style writes at the cursor, wrapping past the capacity.
            slots = (9 * step + np.arange(9)) % 37
            prios = pick.random(9) * 3
            ours.update_batch(slots, prios)
            ref.update_batch(slots, prios)
            idx = pick.integers(0, 37, 12)  # duplicates: last write wins
            p = pick.random(12) * (step + 1)
            ours.update_batch(idx, p)
            ref.update_batch(idx, p)
            np.testing.assert_array_equal(ours.tree, ref.tree)
            assert ours.max_priority == ref.max_priority
            assert ours.total_priority == ref.total_priority

    def test_rejects_bad_priorities(self):
        with pytest.raises(ValueError):
            SumTree(4).update_batch(np.array([0]), np.array([-1.0]))


class TestBufferMirror:
    def test_config_loads_a_jax_dump(self):
        jcfg = _train_cfg(FUSED_MEGASTEP=True, PER_SAMPLE_BACKEND="pallas")
        cfg = torch_cfg(jcfg)
        assert cfg.model_dump() == jcfg.model_dump()
        assert TrainConfig().model_dump().keys() == JaxTrainConfig().model_dump().keys()
        default, jdefault = TrainConfig().model_dump(), JaxTrainConfig().model_dump()
        for key in default:
            if key != "RUN_NAME":
                assert default[key] == jdefault[key], key

    @pytest.mark.parametrize(
        "bad",
        [
            {"MIN_BUFFER_SIZE_TO_TRAIN": 100},
            {"BATCH_SIZE": 100},
            {"PER_SAMPLE_BACKEND": "cuda"},
            {"FUSED_MEGASTEP": True, "ASYNC_ROLLOUTS": True},
            {"FUSED_MEGASTEP": True, "DEVICE_REPLAY": "off"},
            {"PER_BETA_INITIAL": 0.9, "PER_BETA_FINAL": 0.5},
            {"GRADIENT_CLIP_VALUE": 0.0},
            {"OPTIMIZER_TYPE": "Lion"},
        ],
    )
    def test_validators_refuse_what_jax_refuses(self, bad):
        with pytest.raises(ValueError):
            _train_cfg(**bad)
        with pytest.raises(ValueError):
            TrainConfig(**dict(_train_cfg().model_dump(), **bad))

    def test_beta_readiness_and_priority_updates(self):
        jcfg = _train_cfg()
        ours, ref = ExperienceBuffer(torch_cfg(jcfg)), JaxBuffer(jcfg, action_dim=ACTIONS)
        for step in (0, 3, 10, 25):
            assert ours.beta(step) == ref.beta(step)
        pick = np.random.default_rng(1)
        ref.add_dense(
            pick.integers(-1, 2, (20,) + GRID).astype(np.float32),
            pick.random((20, OTHER)).astype(np.float32),
            np.full((20, ACTIONS), 1 / ACTIONS, np.float32),
            pick.normal(size=20).astype(np.float32),
        )
        slots = np.arange(20)
        ours.tree.update_batch(slots, np.full(20, ours.tree.max_priority))
        ours._pos, ours._size = 20, 20
        ours.tree.data_pointer, ours.tree.n_entries = 20, 20
        idx = pick.integers(0, 20, 16)
        td = pick.normal(size=16).astype(np.float32)
        td[3] = np.nan  # non-finite TD -> priority of 0 error
        ours.update_priorities(idx, td)
        ref.update_priorities(idx, td)
        np.testing.assert_array_equal(ours.tree.tree, ref.tree.tree)
        assert (len(ours), ours.is_ready()) == (len(ref), ref.is_ready())


class TestRingScatter:
    @pytest.mark.parametrize("cap,cursor", [(24, 0), (24, 19), (9, 5)])
    def test_matches_jax(self, cap, cursor):
        blocks = _blocks(cap + cursor)
        jstore = {
            "grid": jnp.zeros((cap + 1,) + GRID, jnp.int8),
            "other_features": jnp.zeros((cap + 1, OTHER), jnp.float32),
            "policy_target": jnp.zeros((cap + 1, ACTIONS), jnp.float32),
            "value_target": jnp.zeros(cap + 1, jnp.float32),
            "policy_weight": jnp.ones(cap + 1, jnp.float32),
        }
        tstore = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jstore.items()}
        jout, _, jcount, jpos, jkeep = jax_ring_scatter(
            jstore, jnp.int32(cursor), _to_jax(blocks), cap, with_positions=True
        )
        count, pos, keep = ring_scatter(tstore, cursor, _to_torch(blocks), cap)
        assert int(count) == int(jcount)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        for name in jstore:  # every slot but the trash row
            np.testing.assert_array_equal(tstore[name][:cap].numpy(), np.asarray(jout[name])[:cap])
        if cap == 9:
            assert int(count) > cap  # the ingest wraps: only the newest rows stay

    def test_device_ring_matches_jax(self):
        jcfg = _train_cfg()
        ref = JaxRing(jcfg, grid_shape=GRID, other_dim=OTHER, action_dim=ACTIONS)
        ours = DeviceReplayBuffer(
            torch_cfg(jcfg), grid_shape=GRID, other_dim=OTHER, action_dim=ACTIONS, device=CPU
        )
        for seed in range(4):
            blocks = _blocks(seed)
            jcount = ref.ingest_payload(dict(zip(("mat", "flush"), _to_jax(blocks))))
            count = ours.ingest_payload(dict(zip(("mat", "flush"), _to_torch(blocks))))
            assert count == jcount
            assert (ours._pos, ours._size) == (ref._pos, ref._size)
            np.testing.assert_array_equal(ours.tree.tree, ref.tree.tree)
        for name, v in ref.storage.items():
            np.testing.assert_array_equal(ours.storage[name][:-1].numpy(), np.asarray(v)[:-1])
        assert ours.storage["grid"].dtype == torch.int8


class TestSelfPlayResult:
    def test_drops_the_rows_jax_drops(self):
        mat, _ = _blocks(7)
        rows = {k: v.reshape((-1,) + v.shape[2:]) for k, v in mat.items()}
        args = dict(
            grid=rows["grid"], other_features=rows["other"], policy_target=rows["policy"],
            value_target=rows["ret"], policy_weight=rows["pw"],
        )
        ours, ref = SelfPlayResult(**args), JaxResult(**args)
        assert ours.num_experiences == ref.num_experiences == 10
        for name in args:
            np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))


class TestPerSample:
    @pytest.mark.parametrize("n,k,b", [(1000, 3, 16), (513, 2, 7), (5, 1, 4)])
    def test_count_equals_both_jax_lowerings(self, n, k, b):
        pick = np.random.default_rng(n)
        p = pick.random(n).astype(np.float32)
        p[n // 3 : n // 2] = 0.0  # a zero-priority run: an empty segment
        cum = jnp.cumsum(jnp.asarray(p))
        u = jax.random.uniform(jax.random.PRNGKey(n), (k, b)) * cum[-1]
        u = u.at[0, 0].set(cum[n // 3])  # a draw on a segment edge
        u = u.at[-1, -1].set(cum[-1])  # the total itself: counts every element
        ours = count_below_plain(torch.from_numpy(np.array(cum)), torch.from_numpy(np.array(u)))
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(count_below_xla(cum, u)))
        np.testing.assert_array_equal(
            ours.numpy(), np.asarray(count_below_pallas(cum, u, interpret=True))
        )

    @pytest.mark.parametrize("mode", ["xla", "pallas"])
    def test_indices_match_the_jax_wrapper(self, mode):
        cap = 200
        pick = np.random.default_rng(2)
        p = pick.integers(0, 4, cap + 1).astype(np.float32)  # exact prefix sums
        p[cap] = 0.0  # the trash slot
        key = jax.random.PRNGKey(17)
        jidx, jprobs = jax_per_sample(jnp.asarray(p), cap, 3, 32, key, mode=mode)
        before = KERNELS["per_sample"].launches
        idx, probs = per_sample(torch.from_numpy(p), cap, 3, 32, torch_key(key), mode=mode)
        assert KERNELS["per_sample"].launches == before  # CPU tensors: the plain count
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert (p[idx.numpy()] > 0).all()  # zero-priority slots are never drawn
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6)

    def test_unknown_mode_raises(self):
        cum = torch.arange(4, dtype=torch.float32)
        with pytest.raises(ValueError, match="unknown PER sample mode"):
            count_below(cum, cum[None], mode="cuda")

    @pytest.mark.parametrize("case", COUNT_CASES)
    def test_count_on_adversarial_cases_equals_jax(self, case):
        # The families the card holds the redesigned kernel to
        # (`ops/kernel_cases.py`): the Pallas count on all, NaN and +-inf
        # and unsorted input included; the binary search where `cum` is
        # sorted and finite, as it then must agree.
        cum, u = count_case(case, seed=3, n_large=5000)
        ours = count_below_plain(torch.from_numpy(cum), torch.from_numpy(u)).numpy()
        jcum, ju = jnp.asarray(cum), jnp.asarray(u)
        np.testing.assert_array_equal(
            ours, np.asarray(count_below_pallas(jcum, ju, interpret=True))
        )
        if case not in ("nan_inf", "unsorted"):
            assert (np.diff(cum) >= 0).all()
            np.testing.assert_array_equal(ours, np.asarray(count_below_xla(jcum, ju)))
