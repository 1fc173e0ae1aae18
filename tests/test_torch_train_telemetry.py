"""The telemetry of a port training run against the JAX package's, on the
CPU at the small parity configs:

- In each loop mode (synchronous, overlapped, megastep) the keyword
  arguments the port's loop passes to `RunTelemetry.on_util_tick` are
  recorded and replayed into the JAX `RunTelemetry` and
  `UtilizationMeter` with the same FLOP counts and the same clock: the
  two `kind:"util"` records are equal, apart from `time` and the device
  and memory fields. The port's records are the ones in its
  `metrics.jsonl`.
- Two synchronous iterations of the JAX `TrainingLoop` and the port's,
  from the same weights, configs and seeds (`test_torch_stats.py`'s
  harness), pass the same counters to `on_util_tick`: episodes, rows,
  simulations, the ring's size, iterations and program dispatches.
- Every mode's flight ring pairs each intent with one `ok` seal, per
  family as many as the components count dispatches, none unsealed.
- `train_step_flops` equals the JAX one for the default configs and the
  five presets; the peak table gives the H100 variants NVIDIA's dense
  bf16 figures from the table, and the TPU kinds the JAX package's
  values.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu.config import EnvConfig as JaxEnvConfig  # noqa: E402
from alphatriangle_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from alphatriangle_tpu.config import PersistenceConfig as JaxPersistence  # noqa: E402
from alphatriangle_tpu.config import TelemetryConfig as JaxTelemetryConfig  # noqa: E402
from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from alphatriangle_tpu.config import baseline_preset as jax_preset  # noqa: E402
from alphatriangle_tpu.config import expected_other_features_dim  # noqa: E402
from alphatriangle_tpu.telemetry import RunTelemetry as JaxRunTelemetry  # noqa: E402
from alphatriangle_tpu.telemetry.perf import UtilizationMeter as JaxMeter  # noqa: E402
from alphatriangle_tpu.training.loop import TrainingLoop as JaxLoop  # noqa: E402
from alphatriangle_tpu.training.setup import setup_training_components as jax_setup  # noqa: E402
from alphatriangle_tpu.utils import flops as jflops  # noqa: E402
from alphatriangle_tpu_torch.config import baseline_preset  # noqa: E402
from alphatriangle_tpu_torch.telemetry import flight as flight_mod  # noqa: E402
from alphatriangle_tpu_torch.telemetry.flight import FlightRecorder, read_flight, unsealed_intents  # noqa: E402
from alphatriangle_tpu_torch.telemetry.ledger import read_ledger  # noqa: E402
from alphatriangle_tpu_torch.training import LoopStatus, TrainingLoop, setup_training_components  # noqa: E402
from alphatriangle_tpu_torch.utils import flops as tflops  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import CPU, converted_state_dict, inject_jax_noise, run_root, torch_cfg  # noqa: E402

# Fields a replay cannot share: the wall clock, and what the device is.
UNSHARED = {"time", "device_kind", "peak_bf16_tflops", "peak_source", "mfu"}

MODES = {
    "sync": {},
    "async": {"ASYNC_ROLLOUTS": True, "NUM_SELF_PLAY_WORKERS": 2},
    "megastep": {"FUSED_MEGASTEP": True, "FUSED_LEARNER_STEPS": 2},
}


class _Clock:
    """A monotonic clock that advances 0.5 s a read."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.5
        return self.t


def _cfg(**kw) -> JaxTrainConfig:
    base = dict(
        RUN_NAME="telemetry", AUTO_RESUME_LATEST=False, MAX_TRAINING_STEPS=4,
        SELF_PLAY_BATCH_SIZE=4, ROLLOUT_CHUNK_MOVES=4, BATCH_SIZE=8, BUFFER_CAPACITY=256,
        MIN_BUFFER_SIZE_TO_TRAIN=16, USE_PER=True, PER_BETA_ANNEAL_STEPS=8, N_STEP_RETURNS=2,
        WORKER_UPDATE_FREQ_STEPS=2, CHECKPOINT_SAVE_FREQ_STEPS=4, MAX_EPISODE_MOVES=30,
        RANDOM_SEED=5,
    )
    base.update(kw)
    return JaxTrainConfig(**base)


def _unshared(record: dict) -> dict:
    return {k: v for k, v in record.items() if k not in UNSHARED and not k.startswith("mem_")}


def _record_ticks(telemetry) -> list:
    """Wrap `telemetry.on_util_tick`: (step, kwargs, record) per call."""
    calls, real = [], telemetry.on_util_tick

    def on_util_tick(step, **kwargs):
        record = real(step, **kwargs)
        calls.append((step, dict(kwargs), record))
        return record

    telemetry.on_util_tick = on_util_tick
    return calls


@pytest.fixture(scope="module")
def mode_run(tmp_path_factory, tiny_env_config, tiny_model_config, tiny_mcts_config):
    """Run the port's loop in one mode at the small configs, its meter on
    the stepping clock, once per mode for the module; returns (loop,
    recorded ticks, JAX train config)."""
    runs: dict = {}

    def run(mode: str):
        if mode not in runs:
            jtc = _cfg(**MODES[mode])
            root = tmp_path_factory.mktemp(mode)
            c = setup_training_components(
                torch_cfg(jtc), torch_cfg(tiny_env_config), torch_cfg(tiny_model_config),
                torch_cfg(tiny_mcts_config), persistence_config=run_root(root), device=CPU,
            )
            c.telemetry.perf._clock = _Clock()
            calls = _record_ticks(c.telemetry)
            loop = TrainingLoop(c)
            assert loop.run() == LoopStatus.COMPLETED and loop.global_step == 4
            runs[mode] = (loop, calls, jtc)
        return runs[mode]

    return run


@pytest.mark.parametrize("mode", sorted(MODES))
def test_util_records_replay_into_jax(mode_run, tmp_path, tiny_env_config, tiny_model_config, mode):
    loop, calls, jtc = mode_run(mode)
    meter = loop.c.telemetry.perf
    env, model = tiny_env_config, tiny_model_config
    jforward = jflops.forward_flops(model, env, env.action_dim)
    jstep = jflops.train_step_flops(model, env, env.action_dim, jtc.BATCH_SIZE)
    assert (meter.forward_flops, meter.train_step_flops) == (jforward, jstep) and jstep > 0
    ref = JaxRunTelemetry(
        JaxTelemetryConfig(), run_dir=tmp_path / "jax",
        perf=JaxMeter(
            forward_flops=jforward, train_step_flops=jstep, device_kind="cpu",
            buffer_capacity=jtc.BUFFER_CAPACITY, mesh_devices=1, clock=_Clock(),
        ),
    )
    ticks = loop.iterations + loop.warmup_chunks
    assert len(calls) == ticks >= 3
    ours = [record for _, _, record in calls]
    # The port passes what the JAX meter accounts; the JAX package has a
    # compile cache (none here) and reads its own device's memory.
    theirs = [
        ref.on_util_tick(step, **kwargs, compile_hits=0, compile_misses=0, device_memory=[])
        for step, kwargs, _ in calls
    ]
    assert ours[0] is None and theirs[0] is None
    assert [_unshared(r) for r in ours[1:]] == [_unshared(r) for r in theirs[1:]]
    assert all(kw["dispatch_wall_s"] is not None for _, kw, _ in calls)
    # The device stat-packs (on by default in training) mirror their
    # gauges into the util record of every iteration that folded one.
    extras = [kw["extra"] for _, kw, _ in calls if kw["extra"] is not None]
    assert extras and all(
        set(e) == {"root_visit_entropy", "tree_occupancy", "beacons_armed"} and e["beacons_armed"] == 0
        for e in extras
    )
    if mode != "async":  # every iteration played a chunk
        assert len(extras) == len(calls)
    last = calls[-1][1]
    c = loop.c
    engines = loop._engines()
    final = {
        "episodes": loop.episodes_played, "experiences": loop.experiences_added,
        "simulations": loop.total_simulations, "buffer_size": len(c.buffer),
        "dispatches": c.trainer.dispatch_count + getattr(c.buffer, "dispatch_count", 0)
        + sum(e.dispatch_count for e in engines)
        + (c.megastep.dispatch_count if c.megastep is not None else 0),
    }
    assert last["iterations"] == ticks and final["simulations"] > 0
    for key, value in final.items():
        if mode == "async":  # the shutdown folds what the producers still played
            assert last[key] <= value, key
        else:
            assert last[key] == value, key
    assert last["transfer_d2h_s"] > 0 and 0 < last["dispatch_wall_s"] <= c.telemetry.flight.sealed_wall_seconds
    # The ledger holds the same records, and the collector's ticks.
    run_dir = c.persistence_config.get_run_base_dir()
    ledger = read_ledger(run_dir / "metrics.jsonl")
    utils = [r for r in ledger if r.get("kind") == "util"]
    assert utils == [json.loads(json.dumps(r)) for r in ours[1:]]
    assert sum(r.get("kind") == "device_stats" for r in ledger) == len(extras)
    assert any(r.get("kind") == "tick" and "Loss/total_loss" in r["means"] for r in ledger)
    assert all(r["device_kind"] == "cpu" and r["mfu"] is None for r in utils)
    if mode == "megastep":  # one megastep, one dispatch
        assert utils[-1]["dispatches_per_iteration"] == 1.0
    health = json.loads((run_dir / "health.json").read_text())
    assert health["learner_step"] == 4 and health["device_kind"] == "cpu"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_flight_ring_pairs_every_dispatch(mode_run, mode):
    loop, _, _ = mode_run(mode)
    c = loop.c
    path = c.persistence_config.get_run_base_dir() / "flight.jsonl"
    records = read_flight(path)
    intents = [r for r in records if r.get("phase") == "intent"]
    seals = {r["seq"]: r for r in records if r.get("phase") == "seal"}
    assert intents and unsealed_intents(records) == []
    assert sorted(seals) == sorted(r["seq"] for r in intents)
    for r in intents:
        seal = seals[r["seq"]]
        assert seal["ok"] is True and seal["program"] == r["program"] and seal["wall_s"] >= 0
    by_family: dict = {}
    for r in intents:
        by_family[r["family"]] = by_family.get(r["family"], 0) + 1
    want = {"rollout": sum(e.dispatch_count for e in loop._engines()), "learner": c.trainer.dispatch_count}
    if c.megastep is not None:
        want["megastep"] = c.megastep.dispatch_count
    assert by_family == {k: v for k, v in want.items() if v}
    if mode == "megastep":
        assert want["megastep"] >= 1 and want["learner"] == 0
        assert all(r["program"].startswith("megastep/t4_k") for r in intents if r["family"] == "megastep")
    else:
        assert want["learner"] >= 1 and want["rollout"] >= 1
    flight = c.telemetry.flight
    assert flight.dispatches == len(intents) and flight.overhead_seconds > 0
    overhead = [r for r in read_ledger(path) if r.get("kind") == "flight_overhead"]
    assert len(overhead) == 1 and overhead[0]["dispatches"] == len(intents)


def test_inflight_wall_is_the_union_of_open_spans(tmp_path, monkeypatch):
    """Spans open at once on several threads (the overlapped loop's
    streams beside a learner group) count once in `inflight_wall_s`,
    which also counts an open span up to now; `sealed_wall_seconds`
    sums each sealed span's wall."""
    now = [0.0]
    monkeypatch.setattr(flight_mod.time, "perf_counter", lambda: now[0])
    rec = FlightRecorder(tmp_path / "flight.jsonl")

    def at(t, fn, *args):
        now[0] = t
        return fn(*args)

    a = at(1.0, rec.begin, "rollout", "chunk")
    b = at(2.0, rec.begin, "learner", "group")
    at(4.0, a.seal)
    assert at(5.0, rec.inflight_wall_s) == 4.0
    at(6.0, b.seal)
    c = at(8.0, rec.begin, "rollout", "chunk")
    at(9.0, c.seal, "boom")
    d = at(10.0, rec.begin, "megastep", "step")
    assert at(12.0, rec.inflight_wall_s) == 8.0
    at(13.0, d.seal)
    assert rec.sealed_wall_seconds == 3.0 + 4.0 + 3.0 and rec.inflight_wall_s() == 9.0


def test_sync_counters_match_the_jax_loop(
    monkeypatch, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config
):
    """`test_torch_stats.py`'s two synchronous iterations, each ending in
    the loop's `_iteration_tail`: the same counters reach `on_util_tick`."""
    inject_jax_noise(monkeypatch)
    jtc = _cfg(RUN_NAME="counters", BUFFER_CAPACITY=2000, MAX_TRAINING_STEPS=8)
    jc = jax_setup(
        train_config=jtc, env_config=tiny_env_config, model_config=tiny_model_config,
        mcts_config=tiny_mcts_config,
        persistence_config=JaxPersistence(ROOT_DATA_DIR=str(tmp_path / "jax"), RUN_NAME="s"),
        telemetry_config=JaxTelemetryConfig(), use_tensorboard=False,
    )
    c = setup_training_components(
        torch_cfg(jtc), torch_cfg(tiny_env_config), torch_cfg(tiny_model_config),
        torch_cfg(tiny_mcts_config), persistence_config=run_root(tmp_path / "port"), device=CPU,
    )
    state = converted_state_dict(jc.net)
    c.net.model.load_state_dict(state)
    c.trainer.model.load_state_dict(state)
    jloop, loop = JaxLoop(jc), TrainingLoop(c)
    calls = {"jax": _record_ticks(jloop.telemetry), "port": _record_ticks(loop.telemetry)}
    for _ in range(2):
        for lp in (jloop, loop):
            added = lp._process_rollout()
            lp._run_training_steps(max(1, round(added / jtc.BATCH_SIZE)))
            lp._iteration_tail()
    assert loop.global_step == jloop.global_step == 2
    keys = ("episodes", "experiences", "simulations", "reused_visits", "buffer_size", "iterations",
            "dispatches")
    got = [(step, {k: kw[k] for k in keys}) for step, kw, _ in calls["port"]]
    want = [(step, {k: kw[k] for k in keys}) for step, kw, _ in calls["jax"]]
    assert got == want and got[-1][1]["iterations"] == 2 and got[-1][1]["dispatches"] >= 4
    jc.stats.close()
    c.stats.close()
    jloop.telemetry.close(jloop.global_step)
    loop.telemetry.close(loop.global_step)


@pytest.mark.parametrize("preset", [None, 1, 2, 3, 4, 5])
def test_train_step_flops_match_jax(preset):
    if preset is None:
        jenv = JaxEnvConfig()
        jmodel = JaxModelConfig(OTHER_NN_INPUT_FEATURES_DIM=expected_other_features_dim(jenv))
        jbatch = JaxTrainConfig().BATCH_SIZE
        env, model, batch = torch_cfg(jenv), torch_cfg(jmodel), jbatch
    else:
        jb, b = jax_preset(preset), baseline_preset(preset)
        jenv, jmodel, jbatch = jb["env"], jb["model"], jb["train"].BATCH_SIZE
        env, model, batch = b["env"], b["model"], b["train"].BATCH_SIZE
        assert batch == jbatch
    got = tflops.train_step_flops(model, env, env.action_dim, batch)
    want = jflops.train_step_flops(jmodel, jenv, jenv.action_dim, jbatch)
    assert got == want > 0
    assert got == (4 if model.REMAT else 3) * batch * tflops.forward_flops(model, env, env.action_dim)


@pytest.mark.parametrize(
    "kind,peak",
    [
        ("NVIDIA H100 80GB HBM3", 989.4),
        ("NVIDIA H100 PCIe", 756.0),
        ("NVIDIA H100 NVL", 835.0),
        ("TPU v4", None),
        ("TPU v5 lite", None),
        ("TPU v5litepod-8", None),
        ("TPU v5p", None),
        ("TPU v6e", None),
        ("NVIDIA A100-SXM4-80GB", None),
        ("cpu", None),
    ],
)
def test_peak_table(monkeypatch, kind, peak):
    """The H100 variants by `torch.cuda.get_device_name`, from the table;
    every other kind as the JAX package answers it."""
    monkeypatch.delenv(tflops.PEAK_TFLOPS_ENV, raising=False)
    got = tflops.peak_bf16_tflops_info(kind)
    if peak is not None:
        assert got == (peak, "table")
        assert jflops.peak_bf16_tflops_info(kind) == (None, "unknown")
    else:
        assert got == jflops.peak_bf16_tflops_info(kind)
    monkeypatch.setenv(tflops.PEAK_TFLOPS_ENV, "123.0")
    assert tflops.peak_bf16_tflops_info(kind) == (123.0, "env")
    assert np.isclose(tflops.peak_bf16_tflops_info(kind)[0], jflops.peak_bf16_tflops_info(kind)[0])
