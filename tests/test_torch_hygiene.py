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
                assert words[1].split(".")[0] not in ("jax", "flax", "alphatriangle_tpu"), (
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


def test_cli_serve_on_the_cpu(capsys):
    """The serve subcommand end to end on the default board and net, at a
    small load."""
    import json

    rc = cli.main([
        "serve", "--device", "cpu", "--slots", "2", "--sims", "4", "--sessions", "3",
        "--max-moves", "2", "--seed", "1",
    ])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert report["sessions_served"] == 3 and report["device"] == "cpu"
    assert 3 <= report["moves_served"] <= 6
    assert report["serve_dispatches"] == report["dispatches"] >= 2
