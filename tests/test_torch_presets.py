"""Parity of the PyTorch port's presets (`config/presets.py`,
`config/mesh_config.py`) with the JAX package, and the `cli train`
flags that select them.

- `baseline_preset(n)` for n = 1..5 and the three geometry presets dump
  equal to the JAX ones, config for config.
- `load_tuned_preset` reads an artifact the JAX package wrote into the
  same bundle, and refuses what the JAX loader refuses.
- `cli train --preset 3` (Gumbel root, playout-cap randomization, the
  4-layer transformer) runs on the CPU with its depth cut; `--preset 1`
  goes to the CPU with no `--device`; the flags override the preset.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu.autotune.artifact import write_tuned_preset  # noqa: E402
from alphatriangle_tpu.config import TUNED_PRESET_SCHEMA as JAX_SCHEMA  # noqa: E402
from alphatriangle_tpu.config import baseline_preset as jax_preset  # noqa: E402
from alphatriangle_tpu.config import geometry_preset as jax_geometry  # noqa: E402
from alphatriangle_tpu.config import load_tuned_preset as jax_load  # noqa: E402
from alphatriangle_tpu_torch import cli  # noqa: E402
from alphatriangle_tpu_torch.config import (  # noqa: E402
    TUNED_PRESET_SCHEMA,
    MeshConfig,
    baseline_preset,
    geometry_preset,
    load_tuned_preset,
)
from torch_parity import reset_device_stats  # noqa: E402, F401 (autouse: `cli train` runs in-process)

KEYS = ("env", "model", "train", "mcts", "mesh")
CUTS = ["--max-steps", "2", "--self-play-batch", "2", "--batch-size", "4", "--min-buffer", "4",
        "--buffer-capacity", "64", "--rollout-chunk", "4", "--fused-learner-steps", "1",
        "--no-auto-resume", "--no-tensorboard"]


def _assert_bundle(got: dict, want: dict) -> None:
    for key in KEYS:
        assert got[key].model_dump() == want[key].model_dump(), key
    assert got["description"] == want["description"]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_baseline_preset_matches_jax(n):
    _assert_bundle(baseline_preset(n, run_name="r"), jax_preset(n, run_name="r"))
    assert baseline_preset(n)["train"].RUN_NAME == f"baseline_preset_{n}"


def test_geometry_presets_and_errors():
    for name in ("tiny", "default", "large"):
        assert geometry_preset(name).model_dump() == jax_geometry(name).model_dump()
    with pytest.raises(ValueError, match="Unknown geometry"):
        geometry_preset("huge")
    with pytest.raises(ValueError, match="valid: 1..5"):
        baseline_preset(6)
    assert MeshConfig().resolve_dp_size(1) == 1
    with pytest.raises(ValueError):
        MeshConfig(SP_ATTENTION="flash")


def _artifact(tmp_path, **configs) -> str:
    """A tuned preset written by the JAX package's artifact writer."""
    base = jax_preset(2, run_name="tuned")
    dumps = {k: base[k].model_dump() for k in ("env", "model", "mcts", "train")}
    dumps.update(configs)
    payload = {"schema": JAX_SCHEMA, "description": "autotuned cpu (sync)", "configs": dumps,
               "candidate": {"sp_batch": 128}}
    return str(write_tuned_preset(payload, tmp_path / "tuned_preset.json"))


def test_load_tuned_preset_matches_jax(tmp_path):
    assert TUNED_PRESET_SCHEMA == JAX_SCHEMA
    path = _artifact(tmp_path)
    got, want = load_tuned_preset(path), jax_load(path)
    _assert_bundle(got, want)
    assert got["tuned"] == want["tuned"] and got["tuned"]["candidate"]["sp_batch"] == 128


def test_load_tuned_preset_errors_match_jax(tmp_path):
    bad_schema = tmp_path / "v999.json"
    bad_schema.write_text(json.dumps({"schema": "alphatriangle.tuned_preset.v999", "configs": {}}))
    garbled = tmp_path / "bad.json"
    garbled.write_text("{not json")
    listed = tmp_path / "list.json"
    listed.write_text("[1, 2]")
    no_configs = tmp_path / "noconf.json"
    no_configs.write_text(json.dumps({"schema": JAX_SCHEMA}))
    missing_key = tmp_path / "missing"
    missing_key.mkdir()
    base = jax_preset(2)
    missing = missing_key / "tuned_preset.json"
    missing.write_text(json.dumps({"schema": JAX_SCHEMA, "configs": {
        k: base[k].model_dump() for k in ("env", "model", "train")}}))
    invalid = tmp_path / "invalid"
    invalid.mkdir()
    invalid_path = _artifact(invalid, mcts={"max_simulations": 0})
    cases = [
        (tmp_path / "absent.json", "unreadable"),
        (garbled, "invalid JSON"),
        (listed, "JSON object"),
        (bad_schema, "v999"),
        (no_configs, "missing 'configs'"),
        (missing, "missing 'mcts'"),
        (invalid_path, "validation failed"),
    ]
    for path, match in cases:
        with pytest.raises(ValueError, match=match):
            jax_load(path)
        with pytest.raises(ValueError, match=match):
            load_tuned_preset(path)


def _report(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def two_threads():
    """The training commands below on two intra-op threads: under the
    suite's parallel workers, a process on every core's thread slows the
    whole machine down."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_cli_train_preset3_on_the_cpu(tmp_path, capsys, two_threads):
    """Preset 3's recipe at its widths but two lanes deep: the Gumbel
    search, fast searches of 16 at p = 0.25, the 4-layer transformer."""
    rc = cli.main(["train", "--preset", "3", "--device", "cpu", "--root-dir", str(tmp_path), *CUTS])
    report = _report(capsys)
    assert rc == 0 and report["status"] == "completed" and report["preset"] == "3"
    assert report["steps"] == 2 and report["device"] == "cpu"
    assert np.isfinite(report["losses"]["total_loss"]).all()
    live = [json.loads(line) for line in open(report["live_metrics"])]
    # A line per iteration's tick; the final flush writes one only when
    # events are pending.
    assert report["iterations"] <= len(live) <= report["iterations"] + 1
    fractions = [line["means"]["SelfPlay/Full_Search_Fraction"] for line in live
                 if "SelfPlay/Full_Search_Fraction" in line["means"]]
    assert fractions and all(0.0 <= f <= 1.0 for f in fractions)
    assert report["stats_writers"] == ["live_metrics"]
    configs = json.loads(open(f"{report['run_dir']}/configs.json").read())
    assert configs["mcts"]["root_selection"] == "gumbel"
    assert configs["mcts"]["fast_simulations"] == 16 and configs["model"]["TRANSFORMER_LAYERS"] == 4
    assert configs["train"]["BATCH_SIZE"] == 4  # the flag overrides the preset


def test_cli_train_preset1_goes_to_the_cpu(tmp_path, capsys, two_threads):
    rc = cli.main(["train", "--preset", "1", "--root-dir", str(tmp_path), *CUTS])
    report = _report(capsys)
    assert rc == 0 and report["device"] == "cpu" and report["steps"] == 2


def test_cli_train_flags(tmp_path, capsys, monkeypatch):
    with pytest.raises(SystemExit, match="without --fast-sims"):
        cli.main(["train", "--device", "cpu", "--full-search-prob", "0.5", "--root-dir", str(tmp_path)])
    # --dry-setup builds the components of a tuned preset, with the
    # search flags applied on top, and trains nothing.
    path = _artifact(tmp_path)
    rc = cli.main(["train", "--preset", path, "--dry-setup", "--device", "cpu", "--gumbel",
                   "--fast-sims", "8", "--full-search-prob", "0.5", "--root-dir", str(tmp_path),
                   "--buffer-capacity", "64", "--min-buffer", "64", "--batch-size", "8",
                   "--run-name", "dry", "--no-tensorboard"])
    report = _report(capsys)
    assert rc == 0 and report["dry_setup"] and report["lanes"] == 128
    assert report["stats_writers"] == ["live_metrics"]
    configs = json.loads(open(f"{report['run_dir']}/configs.json").read())
    assert configs["mcts"]["root_selection"] == "gumbel"
    assert (configs["mcts"]["fast_simulations"], configs["mcts"]["full_search_prob"]) == (8, 0.5)
    assert configs["mcts"]["max_simulations"] == 200  # preset 2's, from the artifact
    with pytest.raises(SystemExit, match="--preset"):
        cli.main(["train", "--preset", str(tmp_path / "absent.json"), "--dry-setup"])
