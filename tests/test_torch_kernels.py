"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here is marked `cuda` and skips
without a card; the file imports no JAX, so on a machine with a card
and without JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Both kernels must be bit-equal (`torch.equal`) to their plain versions:
the gather copies floats, and the backup adds each element's entries in
the plain version's order.
"""

import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu_torch.ops import KERNELS, backup_update, gather_rows  # noqa: E402
from alphatriangle_tpu_torch.ops.gather_rows import (  # noqa: E402
    gather_rows_cuda,
    gather_rows_plain,
)
from alphatriangle_tpu_torch.ops.mcts_backup import (  # noqa: E402
    backup_update_cuda,
    backup_update_plain,
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
