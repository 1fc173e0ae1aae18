"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points refuse to run without a card unless the
caller asks for the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu_torch import cli, config  # noqa: E402
from alphatriangle_tpu_torch.device import resolve_device  # noqa: E402
from alphatriangle_tpu_torch.env import TriangleEnv  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import alphatriangle_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "alphatriangle_tpu"))
print(len(names), leaked)
assert not leaked, leaked
assert "alphatriangle_tpu_torch.serving.service" in names and "alphatriangle_tpu_torch.cli" in names
for slice_two in ("rl.megastep", "rl.self_play", "rl.trainer", "rl.device_buffer", "ops.per_sample",
                  "training.loop", "training.runner", "utils.sumtree", "config.train_config"):
    assert "alphatriangle_tpu_torch." + slice_two in names, slice_two
assert "alphatriangle_tpu_torch.ops.subtree_reuse" in names
for slice_six in ("stats.persistence", "arena", "config.persistence_config", "config.run_configs"):
    assert "alphatriangle_tpu_torch." + slice_six in names, slice_six
for slice_seven in ("mcts.gumbel", "config.presets", "config.mesh_config", "stats.collector",
                    "stats.events"):
    assert "alphatriangle_tpu_torch." + slice_seven in names, slice_seven
for slice_ten in ("telemetry", "telemetry.ledger", "telemetry.tracectx", "telemetry.tracer",
                  "telemetry.flight", "telemetry.health", "telemetry.perf", "telemetry.slo",
                  "supervise", "supervise.faults", "supervise.policy", "supervise.supervisor",
                  "serving.router", "serving.replica", "serving.fleet", "config.telemetry_config",
                  "utils.flops"):
    assert "alphatriangle_tpu_torch." + slice_ten in names, slice_ten
for slice_eleven in ("telemetry.anomaly", "utils.helpers", "logging_config", "autotune",
                     "autotune.artifact"):
    assert "alphatriangle_tpu_torch." + slice_eleven in names, slice_eleven
for slice_fourteen in ("parallel", "parallel.distributed", "parallel.sharding",
                       "rl.sharded_device_buffer"):
    assert "alphatriangle_tpu_torch." + slice_fourteen in names, slice_fourteen
for slice_seventeen in ("autotune.space", "autotune.model", "autotune.search", "env.game_state",
                        "env.render", "env.native", "features.extractor", "utils.geometry",
                        "config.app_config"):
    assert "alphatriangle_tpu_torch." + slice_seventeen in names, slice_seventeen
for slice_eighteen in ("analysis", "analysis.model", "analysis.dataflow", "analysis.baseline",
                       "analysis.rules", "analysis.engine"):
    assert "alphatriangle_tpu_torch." + slice_eighteen in names, slice_eighteen
leaked = sorted(
    m for m in sys.modules if m.split(".")[0] in ("optax", "pydantic", "tensorboard", "tensorflow")
)
assert not leaked, leaked
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_names_jax():
    for path in (ROOT / "alphatriangle_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in (
                    "jax", "flax", "optax", "pydantic", "alphatriangle_tpu"
                ), (
                    f"{path}: {line}"
                )


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_card_unless_told_cpu(no_card, capsys):
    env_cfg = config.EnvConfig(
        ROWS=3, COLS=4, PLAYABLE_RANGE_PER_ROW=[(0, 4)] * 3, NUM_SHAPE_SLOTS=1,
        MAX_SHAPE_TRIANGLES=3, LINE_MIN_LENGTH=3,
    )
    model_cfg = config.ModelConfig(
        OTHER_NN_INPUT_FEATURES_DIM=config.expected_other_features_dim(env_cfg)
    )
    for make in (
        lambda **kw: TriangleEnv(env_cfg, **kw),
        lambda **kw: NeuralNetwork(model_cfg, env_cfg, **kw),
        resolve_device,
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(device="cuda")
        make(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["serve", "--sessions", "1"])
    # A smoke asks for one bounded wave, not for the CPU.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["serve", "--smoke", "--sessions", "1"])


def test_cli_serve_on_the_cpu(capsys, tmp_path):
    """The serve subcommand end to end on the default board and net, at a
    small load (its telemetry under `tmp_path`)."""
    import json

    rc = cli.main([
        "serve", "--device", "cpu", "--slots", "2", "--sims", "4", "--sessions", "3",
        "--max-moves", "2", "--seed", "1", "--root-dir", str(tmp_path),
    ])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert report["sessions_served"] == 3 and report["device"] == "cpu"
    assert 3 <= report["moves_served"] <= 6
    assert report["serve_dispatches"] == report["dispatches"] >= 2


def test_cli_serve_smoke_on_the_cpu(capsys, tmp_path):
    """`serve --smoke --device cpu`: one wave, exit 0 once every session
    was served and the service's ledger landed."""
    import json

    rc = cli.main([
        "serve", "--smoke", "--device", "cpu", "--slots", "2", "--sims", "4", "--sessions", "2",
        "--max-moves", "2", "--root-dir", str(tmp_path),
    ])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and report["device"] == "cpu" and report["sessions_served"] == 2
    assert (tmp_path / "AlphaTriangleTPUTorch" / "runs" / "serve" / "metrics.jsonl").exists()


def test_training_needs_a_card_unless_told_cpu(no_card, capsys, tmp_path):
    """Without a card, `train` and `eval` stop before anything touches
    the disk."""
    from alphatriangle_tpu_torch.config import PersistenceConfig, TrainConfig
    from alphatriangle_tpu_torch.training import run_training

    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training(
            TrainConfig(FUSED_MEGASTEP=True),
            persistence_config=PersistenceConfig(ROOT_DATA_DIR=str(tmp_path)),
        )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["train", "--fused-megastep", "--max-steps", "1", "--root-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["eval", "--games", "1", "--root-dir", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []
