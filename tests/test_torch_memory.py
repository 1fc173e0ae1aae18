"""The port's memory ledger (`alphatriangle_tpu_torch/telemetry/memory.py`)
and its commands against the JAX package's (`alphatriangle_tpu/telemetry/
memory.py`, `cli fit` / `cli mem`), on the CPU.

- The same records give the same `compose_budget`, `fit_verdict`,
  `attribution_rows`, `serve_budget_bytes`, `latest_by_component` and
  `summarize_device_memory`; `replay_ring_bytes` and the ring record are
  the JAX ones.
- `replay_ring_bytes` equals the bytes each port ring allocated: the
  device ring, the dp-sharded ring (its shards together) and the host
  ring (no trash row).
- `train_state_record` counts the trainer's tensors: its parameters and
  running statistics as the JAX record counts the same net's, its moments
  twice its parameters.
- Training setup ledgers the state's and the ring's records.
- `sharded_megastep_dp` is the group's world where setup's gate holds.
- `cli fit --device cpu` composes the static parts (exit 2 with no limit
  known; 0 and 1 against a limit) and a measured program's record enters
  the budget as the JAX one does; `cli mem` gives the JAX command's
  payload on a ledger, and exits 2 on a run without records.
- The readers import no torch (a subprocess whose torch, numpy and JAX
  imports raise).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu import cli as jcli  # noqa: E402
from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.nn.network import NeuralNetwork as JaxNetwork  # noqa: E402
from alphatriangle_tpu.rl import Trainer as JaxTrainer  # noqa: E402
from alphatriangle_tpu.telemetry import memory as jmem  # noqa: E402
from alphatriangle_tpu_torch import cli  # noqa: E402
from alphatriangle_tpu_torch.config.mesh_config import Mesh  # noqa: E402
from alphatriangle_tpu_torch.nn import NeuralNetwork  # noqa: E402
from alphatriangle_tpu_torch.rl import ExperienceBuffer, Trainer  # noqa: E402
from alphatriangle_tpu_torch.rl.device_buffer import DeviceReplayBuffer  # noqa: E402
from alphatriangle_tpu_torch.rl.sharded_device_buffer import ShardedDeviceReplayBuffer  # noqa: E402
from alphatriangle_tpu_torch.telemetry import memory as tmem  # noqa: E402
from alphatriangle_tpu_torch.telemetry.ledger import MetricsLedger, read_ledger  # noqa: E402
from alphatriangle_tpu_torch.training import setup_training_components  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import CPU, run_root, small_model_config, torch_cfg  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
GIB = 2**30


def _records() -> list:
    """A run's worth of memory records, every category and shape: an
    older train state superseded by a newer one, device, sharded and host
    rings, programs with and without a peak (a self-play program whose
    arguments hold the parameters), and a record of no known category."""
    state = {"kind": "memory", "category": "state", "component": "train_state",
             "bytes": {"params": 12 * 2**20, "opt_state": 24 * 2**20, "batch_stats": 4096},
             "total": 36 * 2**20 + 4096, "time": 1.0}
    return [
        dict(state, total=1, bytes={"params": 1}),
        state,
        tmem.replay_ring_record(tmem.replay_ring_bytes(250_000, (1, 8, 15), 30, 360), 250_000),
        dict(tmem.replay_ring_record(tmem.replay_ring_bytes(1000, (1, 8, 15), 30, 360, shards=2),
                                     1000, shards=2), component="replay_ring_sharded"),
        dict(tmem.replay_ring_record(10**9, 10**6, location="host"), component="replay_ring_host"),
        tmem.program_memory_record("self_play_chunk/t16", 3 * GIB, argument_bytes=12 * 2**20 + 5 * 2**20),
        tmem.program_memory_record("learner_fused/k16", 2 * GIB, argument_bytes=40 * 2**20),
        {"kind": "memory", "category": "program", "component": "program/old",
         "program": "old", "bytes": {"argument": 7, "output": 9, "temp": 11, "generated_code": 1,
                                     "alias": 4}, "total": 28, "transient": 16},
        {"kind": "memory", "category": "other", "component": "mystery", "bytes": {}, "total": 5},
        "not a record",
    ]


def test_budget_verdict_and_rows_match_jax():
    records = _records()
    assert tmem.compose_budget(records) == jmem.compose_budget(records)
    assert tmem.compose_budget(records)["rollout_resident_bytes"] == 5 * 2**20
    assert tmem.compose_budget([]) == jmem.compose_budget([])
    assert tmem.latest_by_component(records) == jmem.latest_by_component(records)
    assert tmem.attribution_rows(records) == jmem.attribution_rows(records)
    for rec in records[5:8] + [None, {}]:
        assert tmem.serve_budget_bytes(rec) == jmem.serve_budget_bytes(rec)
    total = tmem.compose_budget(records)["total_bytes"]
    for limit in (None, 0, -1, total - 1, total, 80 * GIB, "80"):
        assert tmem.fit_verdict(total, limit) == jmem.fit_verdict(total, limit), limit
    for n in (None, True, 0, 512, 2**10, 3.5 * 2**20, 80 * GIB, -(2**31)):
        assert tmem.fmt_bytes(n) == jmem.fmt_bytes(n)
    rows = [{"bytes_in_use": 10, "peak_bytes_in_use": 20, "bytes_limit": 80},
            {"bytes_in_use": 5, "bytes_limit": 0}, "junk", {"peak_bytes_in_use": None}]
    assert tmem.summarize_device_memory(rows) == jmem.summarize_device_memory(rows)
    assert tmem.summarize_device_memory([]) is jmem.summarize_device_memory([]) is None
    for args in (((250_000, (1, 8, 15), 30, 360)), ((63, (2, 3, 4), 7, 12, 3))):
        assert tmem.replay_ring_bytes(*args) == jmem.replay_ring_bytes(*args)
    ours = tmem.replay_ring_record(123, 64, shards=2, location="host")
    theirs = jmem.replay_ring_record(123, 64, shards=2, location="host")
    assert ours.pop("time") > 0 and theirs.pop("time") > 0 and ours == theirs
    assert (tmem.FIT_OK, tmem.FIT_OVER, tmem.FIT_UNKNOWN) == (jmem.FIT_OK, jmem.FIT_OVER, jmem.FIT_UNKNOWN)
    assert tmem.BYTES_LIMIT_ENV == jmem.BYTES_LIMIT_ENV


@pytest.mark.parametrize("ring", ["device", "sharded", "host"])
def test_replay_ring_bytes_equal_each_rings_allocation(tiny_env_config, tiny_model_config, ring):
    env, model = torch_cfg(tiny_env_config), torch_cfg(tiny_model_config)
    grid, adim = (model.GRID_INPUT_CHANNELS, env.ROWS, env.COLS), env.action_dim
    other = model.OTHER_NN_INPUT_FEATURES_DIM
    cfg = torch_cfg(JaxTrainConfig(BUFFER_CAPACITY=64, MIN_BUFFER_SIZE_TO_TRAIN=4, BATCH_SIZE=8,
                                   RUN_NAME="ring"))
    if ring == "device":
        buf = DeviceReplayBuffer(cfg, grid_shape=grid, other_dim=other, action_dim=adim, device=CPU)
        want = tmem.replay_ring_bytes(64, grid, other, adim)
        assert buf.storage_nbytes() == tmem.tree_bytes(buf.storage) == want
        assert buf.memory_record()["total"] == want and buf.memory_record()["location"] == "device"
    elif ring == "sharded":
        shards = [
            ShardedDeviceReplayBuffer(cfg, grid_shape=grid, other_dim=other, action_dim=adim, device=CPU,
                                      mesh=Mesh(dp=2, dp_index=r))
            for r in range(2)
        ]
        want = tmem.replay_ring_bytes(64, grid, other, adim, shards=2)
        assert sum(tmem.tree_bytes(s.storage) for s in shards) == want
        rec = shards[1].memory_record()
        assert (rec["total"], rec["shards"], rec["capacity"]) == (want, 2, 64)
        assert tmem.compose_budget([rec])["replay_ring_bytes"] == tmem.tree_bytes(shards[0].storage)
    else:
        buf = ExperienceBuffer(cfg, action_dim=adim)
        gen = np.random.default_rng(0)
        buf.add_dense(gen.random((3, *grid), dtype=np.float32), gen.random((3, other), dtype=np.float32),
                      np.full((3, adim), 1.0 / adim, np.float32), np.zeros(3, np.float32))
        # The host ring keeps no trash row.
        assert tmem.tree_bytes(buf._storage) == tmem.replay_ring_bytes(64, grid, other, adim, shards=0)
    assert tmem.replay_ring_bytes(64, grid, other, adim) == jmem.replay_ring_bytes(64, grid, other, adim)


def test_train_state_record_counts_the_trainer(tiny_env_config):
    model_cfg = small_model_config(tiny_env_config, NORM_TYPE="batch")
    tc = JaxTrainConfig(RUN_NAME="state")
    tnet = NeuralNetwork(torch_cfg(model_cfg), torch_cfg(tiny_env_config), seed=0, device=CPU)
    trainer = Trainer(tnet, torch_cfg(tc))
    got = tmem.train_state_record(trainer)
    params = sum(p.numel() * p.element_size() for p in trainer.model.parameters())
    running = sum(b.numel() * b.element_size() for n, b in trainer.model.named_buffers()
                  if n.endswith(("running_mean", "running_var")))
    assert got["bytes"] == {"params": params, "opt_state": 2 * params, "batch_stats": running}
    assert got["total"] == 3 * params + running and running > 0
    want = jmem.train_state_record(JaxTrainer(JaxNetwork(model_cfg, tiny_env_config, seed=0), tc).state)
    assert got["bytes"]["params"] == want["bytes"]["params"]
    assert got["bytes"]["batch_stats"] == want["bytes"]["batch_stats"]
    # optax's state adds its step counters to the two moments.
    assert 0 <= want["bytes"]["opt_state"] - got["bytes"]["opt_state"] <= 64
    assert (got["kind"], got["category"], got["component"]) == ("memory", "state", "train_state")


@pytest.mark.parametrize("ring", ["on", "off"])
def test_setup_ledgers_the_state_and_ring(tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config,
                                          ring):
    tc = JaxTrainConfig(RUN_NAME="mem", BUFFER_CAPACITY=64, MIN_BUFFER_SIZE_TO_TRAIN=8, BATCH_SIZE=8,
                        SELF_PLAY_BATCH_SIZE=2, DEVICE_REPLAY=ring)
    c = setup_training_components(
        torch_cfg(tc), torch_cfg(tiny_env_config), torch_cfg(tiny_model_config), torch_cfg(tiny_mcts_config),
        persistence_config=run_root(tmp_path), device=CPU,
    )
    c.stats.close()
    records = read_ledger(c.persistence_config.get_run_base_dir() / "metrics.jsonl", kinds={"memory"})
    by = {r["component"]: r for r in records}
    assert by["train_state"] == dict(tmem.train_state_record(c.trainer), time=by["train_state"]["time"])
    ring_rec = by["replay_ring"]
    assert ring_rec["location"] == ("device" if ring == "on" else "host")
    grid = (tiny_model_config.GRID_INPUT_CHANNELS, tiny_env_config.ROWS, tiny_env_config.COLS)
    assert ring_rec["total"] == jmem.replay_ring_bytes(64, grid, c.extractor.other_dim,
                                                       tiny_env_config.action_dim)


def _fit(capsys, *args) -> tuple:
    rc = cli.main(["fit", "smoke", "--device", "cpu", "--json", "--programs", "none", *args])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_fit_composes_the_static_parts(monkeypatch, capsys):
    monkeypatch.delenv(tmem.BYTES_LIMIT_ENV, raising=False)
    rc, report = _fit(capsys)
    assert rc == tmem.FIT_UNKNOWN and report["bytes_limit"] is None and report["backend"] == "cpu"
    assert report["scale"] == "smoke" and report["schema"] == "alphatriangle.fit.v1"
    records = report["records"]
    assert {r["component"] for r in records} == {"train_state", "replay_ring"}
    assert report["budget"] == tmem.compose_budget(records) == jmem.compose_budget(records)
    assert report["budget"]["train_state_bytes"] > 0 and report["budget"]["replay_ring_bytes"] == 0
    rc, report = _fit(capsys, "--limit-gb", "1")
    assert (rc, report["limit_source"], report["bytes_limit"]) == (tmem.FIT_OK, "flag", GIB)
    monkeypatch.setenv(tmem.BYTES_LIMIT_ENV, "1000")
    rc, report = _fit(capsys)
    assert (rc, report["limit_source"]) == (tmem.FIT_OVER, "env")
    assert report["reason"] == jmem.fit_verdict(report["budget"]["total_bytes"], 1000.0)[1]


def test_sharded_megastep_dp_follows_the_group(monkeypatch):
    """One process is a world of one; under a group the world, when the
    ring, the batch and the lanes divide over it (setup's gate)."""
    from alphatriangle_tpu_torch.parallel import distributed

    def cfg(lanes):
        return torch_cfg(JaxTrainConfig(BUFFER_CAPACITY=64, MIN_BUFFER_SIZE_TO_TRAIN=8, BATCH_SIZE=8,
                                        SELF_PLAY_BATCH_SIZE=lanes, RUN_NAME="dp"))

    assert tmem.sharded_megastep_dp(cfg(4)) == 1
    monkeypatch.setattr(distributed, "process_info", lambda: (0, 2))
    assert tmem.sharded_megastep_dp(cfg(4)) == 2 and tmem.sharded_megastep_dp(cfg(3)) == 1


def test_measured_program_record_enters_the_budget():
    ran = []
    assert tmem.measure_program("x", lambda: ran.append(1), CPU) is None and ran == [1]
    rec = tmem.program_memory_record("self_play_chunk/t4", 1000, argument_bytes=300, backend="cuda")
    state = {"kind": "memory", "category": "state", "component": "train_state",
             "bytes": {"params": 100}, "total": 250}
    for mod in (tmem, jmem):
        budget = mod.compose_budget([state, rec])
        assert budget["rollout_resident_bytes"] == 200 and budget["program_transient_bytes"] == 1000
        assert mod.serve_budget_bytes(rec) == 1300
    assert tmem.attribution_rows([rec]) == jmem.attribution_rows([rec])


def test_cli_mem_matches_jax_and_exits_2_without_records(tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    MetricsLedger(empty / "metrics.jsonl").append({"kind": "tick", "step": 1, "means": {}})
    assert cli.main(["mem", str(empty / "metrics.jsonl")]) == jcli.main(["mem", str(empty / "metrics.jsonl")]) == 2
    assert cli.main(["mem", str(tmp_path / "absent")]) == 2
    capsys.readouterr()
    run = tmp_path / "run"
    run.mkdir()
    ledger = MetricsLedger(run / "metrics.jsonl")
    for rec in [r for r in _records() if isinstance(r, dict)]:
        ledger.append(rec)
    ledger.append({"kind": "util", "step": 3, "mem_bytes_in_use": 5 * GIB, "mem_peak_bytes_in_use": 6 * GIB,
                   "mem_bytes_limit": 80 * GIB, "mem_utilization": 0.0625})
    path = str(run / "metrics.jsonl")
    assert cli.main(["mem", path, "--json"]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jcli.main(["mem", path, "--json"]) == 0
    assert ours == json.loads(capsys.readouterr().out)
    assert cli.main(["mem", path]) == 0
    text = capsys.readouterr().out
    assert jcli.main(["mem", path]) == 0
    assert text == capsys.readouterr().out
    assert "program/self_play_chunk/t16" in text and "static budget (per device)" in text


_NO_TORCH = (
    "import builtins, sys\n"
    "_real = builtins.__import__\n"
    "def _guard(name, *a, **k):\n"
    "    if name.split('.')[0] in ('torch', 'numpy', 'jax'):\n"
    "        raise ImportError('the reader imported ' + name)\n"
    "    return _real(name, *a, **k)\n"
    "builtins.__import__ = _guard\n"
    "import alphatriangle_tpu_torch.telemetry.memory, alphatriangle_tpu_torch.telemetry.roofline\n"
    "import alphatriangle_tpu_torch.compile_cache\n"
    "from alphatriangle_tpu_torch.cli import main\n"
    "sys.exit(main(sys.argv[1:]))\n"
)


def test_readers_import_no_torch(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    ledger = MetricsLedger(run / "metrics.jsonl")
    for rec in [r for r in _records() if isinstance(r, dict)]:
        ledger.append(rec)
    for argv, want in ((["mem", str(run)], 0), (["mem", str(run), "--json"], 0),
                       (["roofline", str(run)], 2), (["mem", str(tmp_path / "none")], 2)):
        proc = subprocess.run([sys.executable, "-c", _NO_TORCH, *argv], cwd=ROOT, capture_output=True,
                              text=True, timeout=60)
        assert "the reader imported" not in proc.stderr, proc.stderr
        assert proc.returncode == want, (argv, proc.stdout, proc.stderr)
