"""Process-group membership: counterpart of
`alphatriangle_tpu/parallel/distributed.py` on `torch.distributed`.

The port runs one rank per device. Its D ranks stand for the JAX
package's mesh of D devices wherever the JAX package has a path that
only works in one process (the sharded device ring, the dp megastep,
the mdl and sp axes), and for its multi-process run (`jax.distributed`)
in the host-ring loop. `attach_groups` gives a mesh one process group
per line of each axis wider than one rank (the dp line through a rank:
the ranks of its mdl and sp indices; the mdl and sp lines alike), the
world itself where an axis spans every rank. Host-side singleton work (TensorBoard, the live file,
checkpoints, `meta.json`, `configs.json`, telemetry) runs on rank 0
only (`is_primary`).

`DistributedConfig` keeps the JAX fields and their "set together"
rule. With the three explicit fields (`COORDINATOR_ADDRESS` as
`host:port`, or `file://PATH` for a `FileStore`), `initialize_distributed`
builds the rendezvous store itself; with all three `None` it reads
torchrun's `RANK`, `WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT`, which
take the place of JAX's auto-discovery on a pod. The backend is NCCL
for CUDA tensors and gloo on the CPU (`BACKEND="auto"`). NCCL refuses
two ranks on one card, so ranks that share a card raise unless the
caller names gloo, which takes CUDA tensors through host memory;
nothing switches backend quietly. The group has a timeout
(`TIMEOUT_S`), so a rank that dies ends the others' collectives with an
error instead of a hang.
"""

import dataclasses
import datetime
import logging
import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..config._base import ConfigBase, check_choice, check_range
from ..config.mesh_config import Mesh, axis_ranks, indices_of

logger = logging.getLogger(__name__)


@dataclass
class DistributedConfig(ConfigBase):
    """Cluster-membership knobs for `initialize_distributed`."""

    ENABLED: bool = False
    # None = torchrun's environment (RANK / WORLD_SIZE / MASTER_ADDR).
    COORDINATOR_ADDRESS: "str | None" = None
    NUM_PROCESSES: "int | None" = None
    PROCESS_ID: "int | None" = None
    # "auto": NCCL on CUDA, gloo on the CPU. Ranks sharing a card name gloo.
    BACKEND: str = "auto"
    TIMEOUT_S: float = 300.0

    def __post_init__(self) -> None:
        if self.NUM_PROCESSES is not None:
            check_range("NUM_PROCESSES", self.NUM_PROCESSES, ge=1)
        if self.PROCESS_ID is not None:
            check_range("PROCESS_ID", self.PROCESS_ID, ge=0)
        check_choice("BACKEND", self.BACKEND, ("auto", "nccl", "gloo"))
        check_range("TIMEOUT_S", self.TIMEOUT_S, gt=0)
        explicit = (self.COORDINATOR_ADDRESS, self.NUM_PROCESSES, self.PROCESS_ID)
        if any(v is not None for v in explicit) and None in explicit:
            raise ValueError(
                "COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID must be "
                "set together (or all left None for torchrun's environment)."
            )


def _membership(config: DistributedConfig) -> tuple[str, int, int]:
    """(store address, world size, rank) from the fields or torchrun's
    environment."""
    if config.COORDINATOR_ADDRESS is not None:
        return config.COORDINATOR_ADDRESS, int(config.NUM_PROCESSES), int(config.PROCESS_ID)
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in env]
    if missing:
        raise ValueError(
            f"distributed run without --coordinator/--num-processes/--process-id needs "
            f"torchrun's environment; missing {missing}"
        )
    return f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", int(env["WORLD_SIZE"]), int(env["RANK"])


def rank_device(device, rank: int) -> torch.device:
    """The card of this rank: an index-less CUDA device becomes
    `cuda:(LOCAL_RANK or rank) % device_count`; anything else as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def resolve_backend(requested: str, device: torch.device) -> str:
    """"auto" -> NCCL on CUDA, gloo on the CPU; NCCL on the CPU raises."""
    if requested == "auto":
        return "nccl" if device.type == "cuda" else "gloo"
    if requested == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend needs CUDA devices; this rank runs on {device}")
    return requested


def check_card_sharing(backend: str, cards: list) -> None:
    """Raise when two ranks name the same card (`host:device` strings;
    None for a CPU rank) under any backend but gloo: NCCL refuses it."""
    seen: dict = {}
    for rank, card in enumerate(cards):
        if card is None:
            continue
        if card in seen and backend != "gloo":
            raise ValueError(
                f"ranks {seen[card]} and {rank} share the card {card}: NCCL refuses two "
                "ranks on one device. Name the gloo backend (--dist-backend gloo) to run "
                "them on one card."
            )
        seen.setdefault(card, rank)


def _make_store(address: str, world: int, rank: int, timeout: datetime.timedelta):
    if address.startswith("file://"):
        return dist.FileStore(address[len("file://"):], world)
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} is neither host:port nor file://PATH")
    return dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=timeout)


def initialize_distributed(config: "DistributedConfig | None", device="cuda") -> bool:
    """Join the process group if configured; idempotent. Returns whether
    this process is part of a multi-process run after the call. Must run
    before the run's device is touched: it picks this rank's card
    (`rank_device`), checks that no two ranks share one unless gloo is
    named, then initialises the group on the resolved backend."""
    if config is None or not config.ENABLED:
        return dist.is_initialized() and dist.get_world_size() > 1
    if dist.is_initialized():
        return dist.get_world_size() > 1
    address, world, rank = _membership(config)
    if not 0 <= rank < world:
        raise ValueError(f"PROCESS_ID={rank} outside a world of {world}")
    dev = rank_device(device, rank)
    backend = resolve_backend(config.BACKEND, dev)
    timeout = datetime.timedelta(seconds=config.TIMEOUT_S)
    store = _make_store(address, world, rank, timeout)
    store.set(f"card/{rank}", f"{socket.gethostname()}:{dev}" if dev.type == "cuda" else "")
    cards = [store.get(f"card/{r}").decode() or None for r in range(world)]
    check_card_sharing(backend, cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=timeout)
    logger.info("torch.distributed up: rank %d/%d on %s over %s", rank, world, dev, backend)
    return world > 1


def shutdown_distributed() -> None:
    """Leave the process group (end of a run); a no-op outside one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on the process that owns singleton host-side work."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def backend_name() -> "str | None":
    """The group's backend ("nccl" / "gloo"), None outside a group."""
    return dist.get_backend() if dist.is_initialized() else None


def attach_groups(mesh: Mesh) -> Mesh:
    """`mesh` with its axes' process groups (`Mesh.groups`: axis name ->
    this rank's line's group; an axis of one rank is absent, one that
    spans the world is the default group). `dist.new_group` is a
    collective over the whole world: every rank creates every line's
    group of every axis, in one fixed order (dp, mdl, sp; lines by their
    first rank), its own lines and the others' alike, or the run hangs.
    Without a process group the mesh comes back as it is."""
    if not dist.is_initialized():
        return mesh
    world = dist.get_world_size()
    if mesh.size != world:
        raise ValueError(f"a mesh of {mesh.size} ranks over a world of {world}")
    sizes = (mesh.dp, mesh.mdl, mesh.sp)
    here = (mesh.dp_index, mesh.mdl_index, mesh.sp_index)
    groups: dict = {}
    for axis, name in enumerate(mesh.axis_names):
        if sizes[axis] == 1:
            continue
        if sizes[axis] == world:
            groups[name] = dist.group.WORLD
            continue
        mine = axis_ranks(mesh, axis, here)
        seen = set()
        for r in range(world):
            line = tuple(axis_ranks(mesh, axis, indices_of(r, mesh.mdl, mesh.sp)))
            if line in seen:
                continue
            seen.add(line)
            group = dist.new_group(list(line))
            if list(line) == mine:
                groups[name] = group
    logger.info("mesh %s: groups for %s", mesh.shape, sorted(groups))
    return dataclasses.replace(mesh, groups=groups)

