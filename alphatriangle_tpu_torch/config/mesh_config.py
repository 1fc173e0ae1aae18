"""Device-mesh configuration: counterpart of
`alphatriangle_tpu/config/mesh_config.py` (`MeshConfig`, `build_mesh`,
`single_device_mesh`, `rollout_lane_axes`, `lane_shard_count`).

The port runs one rank per device (`parallel/distributed.py`), so a
mesh is a plain description over the process group: its axis names,
the dp width (`resolve_dp_size` of the world size) and this rank's
index on dp. Only the dp axis is real: `MDL_SIZE > 1` (tensor
parallelism) and `SP_SIZE > 1` (ring or Ulysses attention) raise,
since they wait for `ROADMAP.md` item 6b. Nothing here imports torch.
"""

from dataclasses import dataclass

from ._base import ConfigBase, check_choice, check_range

_LATER = "waits for ROADMAP.md item 6b (tensor and sequence parallelism)"


@dataclass(frozen=True)
class Mesh:
    """The (dp, mdl, sp) mesh of a run: `dp` ranks, one per device,
    with mdl = sp = 1. `backend` is the process group's (None: one
    process without a group)."""

    dp: int = 1
    dp_index: int = 0
    axis_names: tuple = ("dp", "mdl", "sp")
    backend: "str | None" = None

    @property
    def shape(self) -> dict:
        dp, mdl, sp = self.axis_names
        return {dp: self.dp, mdl: 1, sp: 1}



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
        each, seen from `rank`."""
        if self.MDL_SIZE > 1:
            raise ValueError(f"MDL_SIZE={self.MDL_SIZE}: tensor parallelism {_LATER}")
        if self.SP_SIZE > 1:
            raise ValueError(f"SP_SIZE={self.SP_SIZE}: sequence parallelism {_LATER}")
        dp = self.resolve_dp_size(world)
        if dp != world:
            raise ValueError(
                f"DP_SIZE={dp} over {world} ranks: the port runs one rank per device, "
                "so the dp axis spans every rank"
            )
        return Mesh(dp=dp, dp_index=rank, axis_names=(self.DP_AXIS, self.MDL_AXIS, self.SP_AXIS),
                    backend=backend)

    @staticmethod
    def single_device_mesh() -> Mesh:
        """A 1x1x1 mesh of one process on one device."""
        return Mesh()


def rollout_lane_axes(mesh: Mesh, dp_axis: str = "dp", sp_axis: str = "sp") -> tuple:
    """Mesh axes the self-play lanes shard over: dp, plus sp when that
    axis is real (never here: `build_mesh` refuses SP_SIZE > 1)."""
    if mesh.shape.get(sp_axis, 1) > 1:
        return (dp_axis, sp_axis)
    return (dp_axis,)


def lane_shard_count(mesh: Mesh, axes: tuple) -> int:
    """How many ways the lane dim splits over `axes` of `mesh`."""
    n = 1
    for ax in axes:
        n *= mesh.shape.get(ax, 1)
    return n
