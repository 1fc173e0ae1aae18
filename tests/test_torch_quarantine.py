"""The recovery policy's quarantine, end to end on the CPU
(`torch_chaos_drill.py`): under `cli supervise --quarantine-after 1` the
first dispatch hang of a `--fused-megastep` child (after step 4 is
committed) quarantines the megastep family, so the restart hands the
child `FUSED_MEGASTEP: False` with `TELEMETRY__BEACONS`; the respawned
child builds the synchronous loop, restores the megastep run's step 4
and completes: exit 0.
"""

import pytest

from alphatriangle_tpu_torch.telemetry.flight import read_flight
from torch_chaos_drill import check_chain, drill
from torch_parity import plain_jax_programs  # noqa: F401 (autouse)
from torch_parity import tiny_preset


@pytest.fixture(scope="module")
def preset(tmp_path_factory, tiny_env_config, tiny_model_config) -> str:
    return tiny_preset(tmp_path_factory.mktemp("quarantine") / "tiny.json", tiny_env_config, tiny_model_config)


def test_quarantined_megastep_respawns_into_the_synchronous_loop(tmp_path, preset):
    d = drill(tmp_path, preset, "hang-dispatch@after=6", ("--quarantine-after", "1"))
    death, respawn, report = check_chain(d, mode="sync")
    assert (death["rc"], death["verdict"], death["family"]) == (113, "dispatch-hung", "megastep")
    assert death["action"] == "restart" and death["progress_step"] == 4
    assert death["overrides"] == respawn["overrides"] == {"TELEMETRY__BEACONS": True, "FUSED_MEGASTEP": False}
    assert "step_00000004.commit" in d["at_death"] and report["resumed_step"] == 4
    after = [r for r in read_flight(d["run"] / "flight.jsonl") if r["time"] >= respawn["time"]]
    families = {r["family"] for r in after}
    assert families == {"rollout", "learner"}, families
