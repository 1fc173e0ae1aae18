"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here is marked `cuda` and skips
without a card; the file imports no JAX, so on a machine with a card
and without JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Every kernel must be bit-equal (`torch.equal`) to its plain version:
the gather and the promotion's row reorder copy floats, the backup adds
each element's entries in the plain version's order (signs of zero
compared too), and the PER count sums integers. The count and the
backup also run on every adversarial family of
`alphatriangle_tpu_torch/ops/kernel_cases.py`, the gather and the backup
at the search shapes of the fast, preset 2, 4 and 5 paths, and the
backup on the operands of real waves (PUCT, Gumbel and fast
searches). One more card test is not a kernel's: the
device ring's snapshot (`get_state` / `set_state`, the checkpoint
spill) round-trips its rows and priorities bit for bit on the card.
"""

import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu_torch.ops import (  # noqa: E402
    KERNELS,
    backup_update,
    count_below,
    gather_rows,
    subtree_promote,
)
from alphatriangle_tpu_torch.ops import mcts_backup as backup_mod  # noqa: E402
from alphatriangle_tpu_torch.ops.gather_rows import (  # noqa: E402
    gather_rows_cuda,
    gather_rows_plain,
)
from alphatriangle_tpu_torch.ops.kernel_cases import (  # noqa: E402
    BACKUP_CASES,
    COUNT_CASES,
    SEARCH_SHAPES,
    backup_case,
    count_case,
    gather_case,
)
from alphatriangle_tpu_torch.ops.mcts_backup import (  # noqa: E402
    backup_update_cuda,
    backup_update_plain,
)
from alphatriangle_tpu_torch.ops.per_sample import (  # noqa: E402
    count_below_cuda,
    count_below_plain,
    per_sample,
    stratum_draws,
)
from alphatriangle_tpu_torch.ops.subtree_reuse import (  # noqa: E402
    promotion_plan,
    reorder_planes_cuda,
    reorder_planes_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("k", [2160, 130, 7])
def test_gather_equals_plain(dev, k):
    gen = torch.Generator(device=dev).manual_seed(k)
    b, n, w = 64, 65, 32
    stats = torch.randn((b, n, k), generator=gen, device=dev)
    idx = torch.randint(0, n, (b, w), generator=gen, device=dev)
    before = KERNELS["gather_rows"].launches
    out = gather_rows(stats, idx, mode="einsum")
    torch.cuda.synchronize()
    assert KERNELS["gather_rows"].launches == before + 1
    assert torch.equal(out, gather_rows_plain(stats, idx))


@pytest.mark.parametrize("shape", sorted(SEARCH_SHAPES))
def test_gather_search_shapes_equal_plain(dev, shape):
    b, n, a, w, _ = SEARCH_SHAPES[shape]
    stats, idx = (torch.from_numpy(x).to(dev) for x in gather_case(b, n, 6 * a, w, seed=n))
    before = KERNELS["gather_rows"].launches
    out = gather_rows(stats, idx, mode="einsum")
    torch.cuda.synchronize()
    assert KERNELS["gather_rows"].launches == before + 1
    assert torch.equal(out, gather_rows_plain(stats, idx))


def test_gather_unaligned_base_takes_the_scalar_path(dev):
    base = torch.randn(4 * 9 * 40 + 1, device=dev)
    stats = base[1:].view(4, 9, 40)  # 4-byte offset: no float4 loads
    idx = torch.randint(0, 9, (4, 5), device=dev)
    out = gather_rows_cuda(stats, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, gather_rows_plain(stats, idx))


def test_gather_refuses_what_it_cannot_take(dev):
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows_cuda(torch.zeros((2, 5, 8), device=dev).transpose(1, 2), torch.zeros(
            (2, 3), dtype=torch.long, device=dev))
    with pytest.raises(ValueError, match="float32"):
        gather_rows_cuda(torch.zeros((2, 5, 8), device=dev, dtype=torch.float16), torch.zeros(
            (2, 3), dtype=torch.long, device=dev))


def _backup_inputs(dev, seed, b=64, n=65, a=360, w=32, d=8):
    gen = torch.Generator(device=dev).manual_seed(seed)
    children = torch.where(
        torch.rand((b, n, a), generator=gen, device=dev) < 0.1,
        torch.randint(1, n, (b, n, a), generator=gen, device=dev).float(),
        torch.tensor(-1.0, device=dev),
    )
    planes = [
        torch.randint(0, 5, (b, n, a), generator=gen, device=dev).float(),
        torch.randn((b, n, a), generator=gen, device=dev),
        children,
        torch.randn((b, n, a), generator=gen, device=dev),
    ]
    parents = torch.randint(0, 4, (b, w), generator=gen, device=dev)
    actions = torch.randint(0, 6, (b, w), generator=gen, device=dev)
    parents[:, 1::4], actions[:, 1::4] = parents[:, 0::4], actions[:, 0::4]
    new_child = torch.where(
        torch.rand((b, w), generator=gen, device=dev) < 0.5,
        torch.randint(1, n, (b, w), generator=gen, device=dev).float(),
        torch.tensor(-1.0, device=dev),
    )
    active = torch.rand((b, w, d), generator=gen, device=dev) < 0.7
    rec_node = torch.where(active, torch.randint(0, 4, (b, w, d), generator=gen, device=dev), -1)
    rec_action = torch.where(active, torch.randint(0, 6, (b, w, d), generator=gen, device=dev), -1)
    updates = (
        parents, actions, new_child, torch.randn((b, w), generator=gen, device=dev),
        rec_node, rec_action, active, torch.randn((b, w, d), generator=gen, device=dev),
    )
    return planes, updates


@pytest.mark.parametrize("seed", [0, 1])
def test_backup_equals_plain_in_place(dev, seed):
    planes, updates = _backup_inputs(dev, seed)
    want = backup_update_plain(*[p.clone() for p in planes], *updates)
    before = KERNELS["backup_update"].launches
    got = backup_update(*planes, *updates, mode="xla")
    torch.cuda.synchronize()
    assert KERNELS["backup_update"].launches == before + 1
    for g, p, wnt in zip(got, planes, want, strict=True):
        assert g is p
        assert torch.equal(g, wnt)


def test_backup_small_shapes_and_int32_indices(dev):
    planes, updates = _backup_inputs(dev, 3, b=3, n=9, a=7, w=8, d=3)
    updates = tuple(u.int() if u.dtype == torch.int64 else u for u in updates)
    want = backup_update_plain(*[p.clone() for p in planes], *updates)
    got = backup_update_cuda(*planes, *updates)
    torch.cuda.synchronize()
    for g, wnt in zip(got, want, strict=True):
        assert torch.equal(g, wnt)


def _on(dev, arrays):
    return [torch.from_numpy(x).to(dev) for x in arrays]


def _bits_equal(x, y) -> bool:
    """Bit for bit: torch.equal, and -0.0 apart from +0.0."""
    return torch.equal(x, y) and torch.equal(torch.signbit(x), torch.signbit(y))


@pytest.mark.parametrize("case", sorted(BACKUP_CASES))
@pytest.mark.parametrize("b", [16, 64])
def test_backup_families_equal_plain(dev, case, b):
    planes, updates = backup_case(case, b=b, n=65, a=360, seed=b)
    planes, updates = _on(dev, planes), _on(dev, updates)
    want = backup_update_plain(*[p.clone() for p in planes], *updates)
    before = KERNELS["backup_update"].launches
    got = backup_update(*planes, *updates)
    torch.cuda.synchronize()
    assert KERNELS["backup_update"].launches == before + 1
    for name, g, wnt in zip(("e_visits", "e_value", "children", "e_reward"), got, want,
                            strict=True):
        assert _bits_equal(g, wnt), name


def test_backup_real_wave_equals_plain(dev, monkeypatch):
    """The operands of real waves, recorded from one full-width search of
    8 games under a random net, through the kernel and the plain version."""
    from alphatriangle_tpu_torch import rng
    from alphatriangle_tpu_torch.config import (
        AlphaTriangleMCTSConfig,
        EnvConfig,
        ModelConfig,
    )
    from alphatriangle_tpu_torch.env import TriangleEnv
    from alphatriangle_tpu_torch.features import FeatureExtractor
    from alphatriangle_tpu_torch.mcts import BatchedMCTS
    from alphatriangle_tpu_torch.mcts import search as search_mod
    from alphatriangle_tpu_torch.nn import NeuralNetwork

    env, model_cfg = TriangleEnv(EnvConfig(), device=dev), ModelConfig()
    net = NeuralNetwork(model_cfg, EnvConfig(), seed=0, device=dev)
    mcts = BatchedMCTS(env, FeatureExtractor(env, model_cfg), net.model,
                       AlphaTriangleMCTSConfig(max_simulations=64), net.support)
    calls = []
    real = search_mod.backup_update

    def record(*args, **kwargs):
        calls.append([x.clone() for x in args])
        return real(*args, **kwargs)

    monkeypatch.setattr(search_mod, "backup_update", record)
    mcts.search(env.reset(rng.split(rng.PRNGKey(1), 8)), rng.PRNGKey(2))
    assert len(calls) == mcts.num_waves
    for args in calls:
        assert bool((~args[10]).any())  # the wave has inactive entries
        got = backup_update_cuda(*[x.clone() for x in args])
        want = backup_update_plain(*[x.clone() for x in args])
        torch.cuda.synchronize()
        for g, wnt in zip(got, want, strict=True):
            assert _bits_equal(g, wnt)


@pytest.mark.parametrize("case", ["gumbel_roots", "random"])
@pytest.mark.parametrize("shape", sorted(SEARCH_SHAPES))
def test_backup_search_shapes_equal_plain(dev, shape, case):
    b, n, a, w, d = SEARCH_SHAPES[shape]
    planes, updates = backup_case(case, b=b, n=n, a=a, seed=n, w=w, d=d)
    planes, updates = _on(dev, planes), _on(dev, updates)
    want = backup_update_plain(*[p.clone() for p in planes], *updates)
    got = backup_update(*planes, *updates)
    torch.cuda.synchronize()
    for g, wnt in zip(got, want, strict=True):
        assert _bits_equal(g, wnt)


@pytest.mark.parametrize("search", ["gumbel", "fast"])
def test_backup_real_gumbel_and_fast_waves_equal_plain(dev, monkeypatch, search):
    """The operands of a Gumbel search's waves (forced roots) and of a
    playout-cap fast search's (16 simulations, exploit), 8 games under a
    random net, through the kernel and the plain version."""
    from alphatriangle_tpu_torch import rng
    from alphatriangle_tpu_torch.config import AlphaTriangleMCTSConfig, EnvConfig, ModelConfig
    from alphatriangle_tpu_torch.env import TriangleEnv
    from alphatriangle_tpu_torch.features import FeatureExtractor
    from alphatriangle_tpu_torch.mcts import GumbelMCTS
    from alphatriangle_tpu_torch.mcts import search as search_mod
    from alphatriangle_tpu_torch.nn import NeuralNetwork

    env, model_cfg = TriangleEnv(EnvConfig(), device=dev), ModelConfig()
    net = NeuralNetwork(model_cfg, EnvConfig(), seed=0, device=dev)
    sims = 64 if search == "gumbel" else 16
    mcts = GumbelMCTS(env, FeatureExtractor(env, model_cfg), net.model,
                      AlphaTriangleMCTSConfig(max_simulations=sims, root_selection="gumbel"),
                      net.support, exploit=search == "fast")
    calls = []
    real = search_mod.backup_update

    def record(*args, **kwargs):
        calls.append([x.clone() for x in args])
        return real(*args, **kwargs)

    monkeypatch.setattr(search_mod, "backup_update", record)
    mcts.search(env.reset(rng.split(rng.PRNGKey(1), 8)), rng.PRNGKey(2))
    assert len(calls) == mcts.num_waves
    for args in calls:
        got = backup_update_cuda(*[x.clone() for x in args])
        want = backup_update_plain(*[x.clone() for x in args])
        torch.cuda.synchronize()
        for g, wnt in zip(got, want, strict=True):
            assert _bits_equal(g, wnt)


def test_backup_reads_rec_active_in_place(dev, monkeypatch):
    planes, updates = _backup_inputs(dev, 4, b=2, n=9, a=7, w=8, d=3)
    seen = []
    monkeypatch.setattr(backup_mod.KERNEL, "launch", lambda *args: seen.append(args))
    backup_update_cuda(*planes, *updates)
    assert seen and seen[0][10] == updates[6].data_ptr()


@pytest.mark.parametrize("w,d", [(32, 32), (64, 16), (1024, 1), (8, 0)])
def test_backup_widest_staging_equals_plain(dev, w, d):
    # 1024 entries a block (no room for the insertion warp; over 48 KB of
    # shared memory), 1024 members, and a wave with no levels.
    planes, updates = _backup_inputs(dev, w + d, b=3, n=9, a=7, w=w, d=d)
    want = backup_update_plain(*[p.clone() for p in planes], *updates)
    got = backup_update_cuda(*planes, *updates)
    torch.cuda.synchronize()
    for g, wnt in zip(got, want, strict=True):
        assert _bits_equal(g, wnt)


def test_backup_refuses_what_it_cannot_take(dev):
    planes, updates = _backup_inputs(dev, 5, b=1, n=9, a=7, w=64, d=17)
    with pytest.raises(ValueError, match="entries"):
        backup_update_cuda(*planes, *updates)


def _priorities(dev, cap: int, seed: int) -> torch.Tensor:
    """(cap + 1,) priorities as the ring holds them: zero-priority runs
    (empty slots), a zero trash slot at `cap`, the rest positive."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = torch.rand(cap + 1, generator=gen, device=dev) * 2.0
    p[cap // 3 : cap // 3 + cap // 10] = 0.0
    p[-(cap // 7 + 1) :] = 0.0
    p[cap] = 0.0
    return p


@pytest.mark.parametrize(
    "cap,k,b", [(250_000, 2, 256), (250_000, 8, 256), (1, 1, 1), (2047, 3, 5), (2049, 1, 257)]
)
def test_per_sample_count_equals_plain(dev, cap, k, b):
    p = _priorities(dev, cap, seed=cap + k)
    cum = torch.cumsum(p[:cap], dim=0)
    u = stratum_draws(cum, k, b, torch.tensor([0, cap + b], dtype=torch.int64))
    u[0, 0] = cum[cap // 3]  # on the edge of a zero run
    u[-1, -1] = cum[-1]  # the total: every element counts
    before = KERNELS["per_sample"].launches
    got = count_below(cum, u, mode="pallas")
    torch.cuda.synchronize()
    assert KERNELS["per_sample"].launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, count_below_plain(cum, u))


def test_per_sample_count_is_exact_on_unsorted_input(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    cum = torch.randn(9000, generator=gen, device=dev)
    cum[17], cum[4000] = float("nan"), float("inf")
    u = torch.randn((3, 100), generator=gen, device=dev)
    u[1, 2] = float("nan")
    assert torch.equal(count_below_cuda(cum, u), count_below_plain(cum, u))


@pytest.mark.parametrize("case", COUNT_CASES)
def test_per_sample_families_equal_plain(dev, case):
    cum, u = _on(dev, count_case(case, seed=7))
    before = KERNELS["per_sample"].launches
    got = count_below(cum, u)
    torch.cuda.synchronize()
    assert KERNELS["per_sample"].launches == before + 1
    assert torch.equal(got, count_below_plain(cum, u))


def test_per_sample_unaligned_cum_takes_the_scalar_path(dev):
    cum, u = _on(dev, count_case("ragged_above", seed=8))
    base = torch.empty(cum.numel() + 1, device=dev)
    shifted = base[1:].copy_(cum)  # 4-byte offset: no 16-byte loads
    assert torch.equal(count_below_cuda(shifted, u), count_below_plain(cum, u))


def test_per_sample_draw_launches_once_and_skips_empty_slots(dev):
    cap, k, b = 250_000, 2, 256
    # Small-integer priorities: their prefix sums are exact, so the card's
    # scan (whose float sums differ from run to run) gives the same cumsum
    # twice.
    p = (_priorities(dev, cap, seed=9) * 2).floor()
    key = torch.tensor([3, 4], dtype=torch.int64)
    before = KERNELS["per_sample"].launches
    idx, probs = per_sample(p, cap, k, b, key, mode="xla")
    torch.cuda.synchronize()
    assert KERNELS["per_sample"].launches == before + 1
    cum = torch.cumsum(p[:cap], dim=0)
    want = count_below_plain(cum, stratum_draws(cum, k, b, key)).clamp(0, cap - 1).long()
    assert torch.equal(idx, want)
    assert bool((p[idx] > 0).all())
    assert bool(torch.isfinite(probs).all())


def test_per_sample_refuses_what_it_cannot_take(dev):
    cum = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="float32"):
        count_below_cuda(cum.double(), torch.zeros((1, 2), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        count_below_cuda(cum, torch.zeros((4, 2), device=dev).t())
    with pytest.raises(ValueError, match="unknown PER sample mode"):
        count_below(cum, torch.zeros((1, 2), device=dev), mode="cuda")


def _promote_inputs(dev, seed, b, n, a):
    """Six edge planes around random forests built as a search builds
    them (child ids increasing away from the root, one parent edge per
    node), with invalid lanes (the chosen child unexpanded) and lanes
    whose subtree outgrows the budget; and the played actions."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    barange = torch.arange(b, device=dev)
    children = torch.full((b, n, a), -1.0, device=dev)
    # Node 1 hangs under the root on action 0; in even lanes every later
    # node descends from node 1 (a subtree of up to N - 1 rows).
    children[:, 0, 0] = 1.0
    for j in range(2, n):
        lo = (barange % 2 == 0).long()
        parent = lo + (torch.rand(b, generator=gen, device=dev) * (j - lo)).long()
        act = torch.randint(0, a, (b,), generator=gen, device=dev)
        free = children[barange, parent, act] < 0
        children[barange[free], parent[free], act[free]] = float(j)
    actions = torch.zeros(b, dtype=torch.int64, device=dev)
    actions[1::4] = a - 1  # unexpanded at the root: invalid promotions
    children[1::4, 0, a - 1] = -1.0
    planes = [
        torch.randint(0, 9, (b, n, a), generator=gen, device=dev).float(),
        torch.randn((b, n, a), generator=gen, device=dev),
        torch.randn((b, n, a), generator=gen, device=dev),
        children,
        torch.rand((b, n, a), generator=gen, device=dev),
        (torch.rand((b, n, a), generator=gen, device=dev) < 0.7).float(),
    ]
    terminal = torch.rand((b, n), generator=gen, device=dev) < 0.2
    return planes, terminal, actions


@pytest.mark.parametrize("b", [64, 512])
def test_promote_equals_plain(dev, b):
    n, a, budget = 129, 360, 65
    planes, terminal, actions = _promote_inputs(dev, b, b, n, a)
    order, _, keep, new_children, valid, retained = promotion_plan(planes[3], actions, budget, 8)
    assert not bool(valid[1::4].any()) and bool((retained == budget).any())
    ins = (*planes[:3], new_children, *planes[4:])
    before = KERNELS["subtree_promote"].launches
    got = subtree_promote(*planes, terminal, actions, max_retained=budget, bfs_rounds=8, mode="xla")
    torch.cuda.synchronize()
    assert KERNELS["subtree_promote"].launches == before + 1
    for g, w in zip(got[:6], reorder_planes_plain(order, keep, ins), strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", [(3, 8, 3), (5, 9, 40)])
def test_promote_small_and_unaligned_shapes(dev, shape):
    b, n, a = shape
    planes, _, actions = _promote_inputs(dev, 7, b, n, a)
    order, _, keep, new_children, _, retained = promotion_plan(planes[3], actions, n // 2, 4)
    ins = [*planes[:3], new_children, *planes[4:]]
    # A 4-byte offset: no float4 moves.
    base = torch.randn(b * n * a + 1, device=dev)
    ins[2] = base[1:].view(b, n, a).copy_(ins[2])
    got = reorder_planes_cuda(order, retained, ins)
    torch.cuda.synchronize()
    for g, w in zip(got, reorder_planes_plain(order, keep, ins), strict=True):
        assert torch.equal(g, w)


def test_promote_refuses_what_it_cannot_take(dev):
    planes, terminal, actions = _promote_inputs(dev, 3, 2, 8, 4)
    order, _, _, _, _, retained = promotion_plan(planes[3], actions, 4, 4)
    with pytest.raises(ValueError, match="float32"):
        reorder_planes_cuda(order, retained, [p.double() for p in planes])
    with pytest.raises(ValueError, match="contiguous"):
        strided = [p.transpose(1, 2).contiguous().transpose(1, 2) for p in planes]
        reorder_planes_cuda(order, retained, strided)
    with pytest.raises(ValueError, match="shape"):
        reorder_planes_cuda(order[:, :4], retained, planes)
    with pytest.raises(ValueError, match="unknown subtree_promote mode"):
        subtree_promote(*planes, terminal, actions, max_retained=4, bfs_rounds=4, mode="cuda")


def test_device_ring_state_round_trip(dev, tmp_path):
    """A wrapped device ring on the card, spilled and restored into a
    fresh one: every row, the trash row (zero), the SumTree leaves and
    the next draws are bit-equal."""
    import numpy as np

    from alphatriangle_tpu_torch.config import PersistenceConfig, TrainConfig
    from alphatriangle_tpu_torch.rl import DeviceReplayBuffer
    from alphatriangle_tpu_torch.stats import CheckpointManager

    cfg = TrainConfig(BUFFER_CAPACITY=300, BATCH_SIZE=32, MIN_BUFFER_SIZE_TO_TRAIN=32, RANDOM_SEED=3)

    def ring():
        return DeviceReplayBuffer(cfg, grid_shape=(1, 8, 15), other_dim=30, action_dim=360, device=dev)

    pick = np.random.default_rng(0)
    policy = pick.random((420, 360)).astype(np.float32)
    policy /= policy.sum(-1, keepdims=True)
    src = ring()
    src.add_dense(
        pick.integers(-1, 2, (420, 1, 8, 15)).astype(np.float32),
        pick.random((420, 30)).astype(np.float32), policy,
        pick.normal(size=420).astype(np.float32),
    )
    src.update_priorities(np.arange(300), pick.random(300) * 3)
    mgr = CheckpointManager(PersistenceConfig(ROOT_DATA_DIR=str(tmp_path)), device=dev)
    spill = mgr.save_buffer(7, src)
    dst = ring()
    assert mgr.restore_buffer_path(dst, spill)
    order = np.roll(np.arange(300), -src._pos)  # restored oldest first
    idx = torch.from_numpy(order).to(dev)
    for name, col in src.storage.items():
        assert torch.equal(dst.storage[name][:300], col[idx]), name
        assert not dst.storage[name][300].any()
    leaves = src.tree.tree[src.tree._cap2 :][:300]
    np.testing.assert_array_equal(dst.tree.tree[dst.tree._cap2 :][:300], leaves[order])
    again = ring()
    again.set_state(dst.get_state())
    for name, col in dst.storage.items():
        assert torch.equal(again.storage[name], col), name
    np.testing.assert_array_equal(again.tree.tree, dst.tree.tree)
    a, b = again.sample(32, current_train_step=1), dst.sample(32, current_train_step=1)
    np.testing.assert_array_equal(a["indices"], b["indices"])
    np.testing.assert_array_equal(a["weights"], b["weights"])
