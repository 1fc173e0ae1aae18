"""Chaos drills of `cli supervise -- train --fused-megastep` on the CPU
(`torch_chaos_drill.py`):

- hang-dispatch at the 3rd megastep's dispatch (after step 4 is
  committed): the child's dispatch watchdog exits 113; the supervisor
  classifies the death as dispatch-hung in the megastep family, restarts
  with `TELEMETRY__BEACONS`, and the respawn resumes at step 4 (nothing
  lost), writes beacon rows and completes: exit 0.
- sigkill-save at step 4: the child dies by SIGKILL between the meta
  and the commit marker; at the death the run holds a torn, uncommitted
  step_4; the supervisor restarts from step 2 and the run completes.

The quarantined respawn of the same hang is `test_torch_quarantine.py`.
"""

import pytest

from alphatriangle_tpu_torch.telemetry.flight import read_flight
from alphatriangle_tpu_torch.telemetry.ledger import read_ledger
from torch_chaos_drill import K, check_chain, drill
from torch_parity import plain_jax_programs  # noqa: F401 (autouse)
from torch_parity import tiny_preset


@pytest.fixture(scope="module")
def preset(tmp_path_factory, tiny_env_config, tiny_model_config) -> str:
    return tiny_preset(tmp_path_factory.mktemp("chaos") / "tiny.json", tiny_env_config, tiny_model_config)


def test_supervised_megastep_survives_a_dispatch_hang(tmp_path, preset):
    # Three warm-up chunks, then megasteps: dispatch 6 is the 3rd megastep.
    d = drill(tmp_path, preset, "hang-dispatch@after=6")
    death, respawn, report = check_chain(d)
    assert (death["rc"], death["verdict"], death["family"], death["program"]) == (
        113, "dispatch-hung", "megastep", "megastep/t2_k2")
    assert death["action"] == "restart" and death["progress_step"] == 4
    assert death["overrides"] == respawn["overrides"] == {"TELEMETRY__BEACONS": True}
    assert report["resumed_step"] == 4
    first = [r for r in read_flight(d["run"] / "flight.jsonl") if r["time"] < respawn["time"]]
    sealed = [r for r in first if r["phase"] == "seal" and r["family"] == "megastep"]
    assert len(sealed) * K - report["resumed_step"] == 0  # nothing lost
    rows = [b for b in read_ledger(d["run"] / "beacons.jsonl") if b["time"] >= respawn["time"]]
    assert rows and {b["phase"] for b in rows} >= {"search_wave"}
    assert (d["run"] / "wedge_report.json.attempt1").is_file()
    assert "step_00000004.commit" in d["at_death"]


def test_supervised_megastep_survives_a_kill_mid_save(tmp_path, preset):
    d = drill(tmp_path, preset, "sigkill-save@step=4")
    death, respawn, report = check_chain(d)
    assert death["rc"] == -9 and death["action"] == "restart" and death["progress_step"] == 2
    assert respawn["overrides"] == {} and report["resumed_step"] == 2
    # At the death: step 4's state and meta on disk, its commit marker not.
    assert d["at_death"]["step_00000004"] == ["train_state.pt"]
    assert "step_00000004.meta.json" in d["at_death"] and "step_00000004.commit" not in d["at_death"]
    assert "step_00000002.commit" in d["at_death"]
    # The respawn saved step 4 again, committed.
    assert (d["run"] / "checkpoints" / "step_00000004.commit").is_file()
    assert (tmp_path / "f" / "sigkill-save.fired").is_file()
