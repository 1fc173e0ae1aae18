"""Device-mesh configuration: counterpart of
`alphatriangle_tpu/config/mesh_config.py` (`MeshConfig`, `build_mesh`,
`single_device_mesh`, `rollout_lane_axes`, `lane_shard_count`).

The port runs one rank per device (`parallel/distributed.py`), so a
mesh is a plain description over the process group: its axis names,
the sizes of its three axes and this rank's index on each. Ranks map
row-major onto (dp, mdl, sp), `rank = (dp_i * MDL + mdl_i) * SP + sp_i`,
the order of `np.asarray(devices).reshape(dp, MDL, SP)` in the JAX
`build_mesh`. dp shards the batch, mdl the transformer's weights
(Megatron layout, `parallel/sharding.py`) and sp the learner's attention
over the sequence (`parallel/ring_attention.py`); self-play lanes ride
(dp, sp) and are replicated over mdl (`rollout_lane_axes`). The process
groups of the axes are attached by `parallel.distributed.attach_groups`
(`groups`). Nothing here imports torch.
"""

from dataclasses import dataclass, field

from ._base import ConfigBase, check_choice, check_range


@dataclass(frozen=True)
class Mesh:
    """The (dp, mdl, sp) mesh of a run seen from one rank: the three
    axis sizes and this rank's index on each. `backend` is the process
    group's (None: one process without a group); `groups` maps an axis
    name to its line's process group (`parallel.distributed.attach_groups`;
    None before that, or for a one-process mesh)."""

    dp: int = 1
    dp_index: int = 0
    axis_names: tuple = ("dp", "mdl", "sp")
    backend: "str | None" = None
    mdl: int = 1
    mdl_index: int = 0
    sp: int = 1
    sp_index: int = 0
    groups: "dict | None" = field(default=None, compare=False, repr=False)

    def __deepcopy__(self, memo):
        # Immutable, and its process groups cannot be copied: a module
        # copied with its mesh (`nn/model.py`'s tensor-parallel layers)
        # shares it.
        return self

    @property
    def shape(self) -> dict:
        dp, mdl, sp = self.axis_names
        return {dp: self.dp, mdl: self.mdl, sp: self.sp}

    @property
    def size(self) -> int:
        """The ranks the mesh spans."""
        return self.dp * self.mdl * self.sp

    @property
    def rank(self) -> int:
        """This rank's place in the row-major (dp, mdl, sp) order."""
        return rank_of(self, self.dp_index, self.mdl_index, self.sp_index)

    @property
    def lane_owner(self) -> bool:
        """Does this rank count its lanes? mdl replicas play the lanes of
        their mdl index 0, which alone counts them."""
        return self.mdl_index == 0

    @property
    def row_owner(self) -> bool:
        """Does this rank count its dp row's replay rows? Every (mdl, sp)
        rank of a row holds them; the first alone counts them."""
        return self.mdl_index == 0 and self.sp_index == 0


def rank_of(mesh: Mesh, dp_index: int, mdl_index: int, sp_index: int) -> int:
    """The rank at mesh indices (dp_i, mdl_i, sp_i)."""
    return (dp_index * mesh.mdl + mdl_index) * mesh.sp + sp_index


def indices_of(rank: int, mdl: int, sp: int) -> tuple:
    """(dp_i, mdl_i, sp_i) of `rank` on a mesh of mdl x sp ranks a dp row."""
    dp_i, rest = divmod(rank, mdl * sp)
    return (dp_i, *divmod(rest, sp))


def axis_ranks(mesh: Mesh, axis: int, at: tuple) -> list:
    """The ranks of the line along `axis` (0 dp, 1 mdl, 2 sp) through
    mesh indices `at`, in axis order."""
    sizes = (mesh.dp, mesh.mdl, mesh.sp)
    out = []
    for i in range(sizes[axis]):
        idx = list(at)
        idx[axis] = i
        out.append(rank_of(mesh, *idx))
    return out


@dataclass
class MeshConfig(ConfigBase):
    """Mesh shape and axis names."""

    # -1 means "all remaining devices" on the dp axis.
    DP_SIZE: int = -1
    MDL_SIZE: int = 1
    SP_SIZE: int = 1
    DP_AXIS: str = "dp"
    MDL_AXIS: str = "mdl"
    SP_AXIS: str = "sp"
    SP_ATTENTION: str = "ring"
    PLATFORM: str = "auto"

    def __post_init__(self) -> None:
        check_range("MDL_SIZE", self.MDL_SIZE, ge=1)
        check_range("SP_SIZE", self.SP_SIZE, ge=1)
        check_choice("SP_ATTENTION", self.SP_ATTENTION, ("ring", "ulysses"))
        check_choice("PLATFORM", self.PLATFORM, ("auto", "tpu", "cpu"))

    def resolve_dp_size(self, n_devices: int) -> int:
        """The dp width over `n_devices` (-1: all that MDL x SP leave)."""
        other = self.MDL_SIZE * self.SP_SIZE
        if self.DP_SIZE == -1:
            if n_devices % other != 0:
                raise ValueError(f"{n_devices} devices not divisible by MDL_SIZE*SP_SIZE={other}")
            return n_devices // other
        return self.DP_SIZE

    def build_mesh(self, world: int, rank: int, backend: "str | None" = None) -> Mesh:
        """The mesh over a process group of `world` ranks, one device
        each, seen from `rank`. Raises when the world cannot hold it
        (without a group the world is one process) or leaves ranks out
        of it."""
        mdl, sp = self.MDL_SIZE, self.SP_SIZE
        if self.DP_SIZE == -1 and world % (mdl * sp):
            dp = max(1, world // (mdl * sp))  # named below: the ranks it needs
        else:
            dp = self.resolve_dp_size(world)
        needed = dp * mdl * sp
        if needed > world:
            raise ValueError(
                f"Mesh needs {needed} ranks (dp={dp} x mdl={mdl} x sp={sp}), only {world} "
                "available: start that many ranks (one per device) under torch.distributed"
            )
        if needed != world:
            raise ValueError(
                f"Mesh of {needed} ranks (dp={dp} x mdl={mdl} x sp={sp}) over {world} ranks: the "
                "port runs one rank per device, so the mesh spans every rank"
            )
        dp_i, mdl_i, sp_i = indices_of(rank, mdl, sp)
        return Mesh(dp=dp, dp_index=dp_i, axis_names=(self.DP_AXIS, self.MDL_AXIS, self.SP_AXIS),
                    backend=backend, mdl=mdl, mdl_index=mdl_i, sp=sp, sp_index=sp_i)

    @staticmethod
    def single_device_mesh() -> Mesh:
        """A 1x1x1 mesh of one process on one device."""
        return Mesh()


def rollout_lane_axes(mesh: Mesh, dp_axis: str = "dp", sp_axis: str = "sp") -> tuple:
    """Mesh axes the self-play lanes shard over: dp, plus sp when that
    axis is real (sequence parallelism never applies to the board-sized
    rollout net, so the sp ranks play lanes of their own); the lanes are
    replicated over mdl."""
    if mesh.shape.get(sp_axis, 1) > 1:
        return (dp_axis, sp_axis)
    return (dp_axis,)


def lane_shard_count(mesh: Mesh, axes: tuple) -> int:
    """How many ways the lane dim splits over `axes` of `mesh`."""
    n = 1
    for ax in axes:
        n *= mesh.shape.get(ax, 1)
    return n
