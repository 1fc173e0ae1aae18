"""Device-mesh configuration: counterpart of
`alphatriangle_tpu/config/mesh_config.py`, fields and validators only.

A preset bundle carries a `MeshConfig`, so the port loads one. It
builds no mesh: the port trains on one device, and `DP_SIZE=-1` (every
preset's value) resolves to that one device. Sharding over several
cards waits for the multi-GPU slice.
"""

from dataclasses import dataclass

from ._base import ConfigBase, check_choice, check_range


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
