"""The port's roofline plane (`alphatriangle_tpu_torch/telemetry/roofline.py`,
`cli roofline`, `cli perf`'s roofline fold) against the JAX package's, on
the CPU.

- The same cost records, flight ring and `trace.json` give the same
  `roofline_rows`, `attribute_gaps`, `load_trace_spans`,
  `latest_cost_by_program`, `cost_flops_by_family` and
  `summarize_roofline` (at a device kind both tables hold).
- The H100 rows of the bandwidth table are NVIDIA's published figures
  under `torch.cuda.get_device_name`'s names, and the machine balance is
  the bf16 peak over them.
- A `cli train` run on the CPU ledgers an analytic cost record for each
  program it dispatched (the chunk's and the learner group's FLOPs as
  the module's formulas give them), and `cli roofline --json` of it is
  the JAX command's payload on the same ledger; `cli roofline` exits 2 on
  a run without cost records or flight ring.
- The cost builders count the weights once per network evaluation (a
  search's waves and its root) and a learner group's parameters and
  moments read and written at every step, as their formulas say.
- The build cache counts a kernel build as a miss and a load of a built
  library as a hit, each with a `compile/<kernel>` span.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu import cli as jcli  # noqa: E402
from alphatriangle_tpu.telemetry import roofline as jroof  # noqa: E402
from alphatriangle_tpu_torch import cli  # noqa: E402
from alphatriangle_tpu_torch import compile_cache  # noqa: E402
from alphatriangle_tpu_torch.config import TrainConfig  # noqa: E402
from alphatriangle_tpu_torch.telemetry import roofline as troof  # noqa: E402
from alphatriangle_tpu_torch.telemetry.flight import summarize_flight  # noqa: E402
from alphatriangle_tpu_torch.telemetry.ledger import MetricsLedger, read_ledger  # noqa: E402
from alphatriangle_tpu_torch.telemetry.tracer import SpanTracer  # noqa: E402
from alphatriangle_tpu_torch.utils.flops import forward_flops, train_step_flops  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import tiny_preset, torch_cfg  # noqa: E402

PROGRAMS = ("self_play_chunk/t4", "learner_fused_steps", "megastep/t2_k2", "serve/b64")


def _flight() -> list:
    """Intent / seal pairs of four programs on a 10 s timeline with
    idle gaps between them, one intent never sealed and one seal whose
    intent is missing; wall clock 1000 s ahead of the monotonic one."""
    out, t, seq = [], 5.0, 0
    for i in range(12):
        program = PROGRAMS[i % 4]
        seq += 1
        wall = 0.1 + 0.05 * (i % 3)
        out.append({"phase": "intent", "seq": seq, "program": program, "t_mono": t, "time": 1000.0 + t})
        out.append({"phase": "seal", "seq": seq, "program": program, "family": program.split("/")[0],
                    "ok": i != 7, "wall_s": wall, "t_mono": t + wall, "time": 1000.0 + t + wall})
        t += wall + 0.3 + 0.1 * (i % 2)
    out.append({"phase": "intent", "seq": 99, "program": "serve/b64", "t_mono": t, "time": 1000.0 + t})
    out.append({"phase": "seal", "seq": 98, "program": "serve/b64", "t_mono": t + 0.2})
    return out


def _costs() -> list:
    return [
        troof.program_cost_record("self_play_chunk/t4", 4e12, 2e9, key="B512xT4"),
        troof.program_cost_record("learner_fused_steps", 1e11, 4e8, key="K2xB256"),
        troof.program_cost_record("learner_fused_steps", 2e11, 4e8, key="K4xB256"),
        troof.program_cost_record("megastep/t2_k2", None, 1e9),
        {"kind": "cost", "program": "serve/b64", "flops": 5e10, "bytes_accessed": 0},
        {"kind": "memory", "program": "self_play_chunk/t4"},
        "junk",
    ]


def _trace(tmp_path):
    tracer = SpanTracer()
    for name, begin, end in (("rollout", 1005.45, 1005.6), ("fold", 1006.0, 1006.2),
                             ("checkpoint", 1008.0, 1009.5), ("sample", 1010.0, 1010.1),
                             ("train", 1007.0, 1007.05), ("telemetry_tick", 1011.0, 1011.2)):
        tracer.complete(name, int(begin * 1e9), int(end * 1e9))
    path = tmp_path / "trace.json"
    tracer.export(path)
    return path


def test_rows_gaps_and_summary_match_jax(tmp_path):
    flight, costs, trace = _flight(), _costs(), _trace(tmp_path)
    rows = summarize_flight(flight)
    for peak, hbm in ((None, None), (275.0, 1228.0), (989.4, 3350.0), (0.0, 100.0)):
        assert troof.roofline_rows(costs, rows, peak, hbm) == jroof.roofline_rows(costs, rows, peak, hbm)
        assert troof.machine_balance_flops_per_byte(peak, hbm) == jroof.machine_balance_flops_per_byte(peak, hbm)
    spans = troof.load_trace_spans(trace)
    assert spans == jroof.load_trace_spans(trace) and {s[0] for s in spans} == {"fetch", "ingest",
                                                                                "checkpoint", "ledger"}
    assert troof.load_trace_spans(tmp_path / "absent.json") == jroof.load_trace_spans(tmp_path / "absent.json") == []
    for sp in (spans, None):
        assert troof.attribute_gaps(flight, sp) == jroof.attribute_gaps(flight, sp)
    gaps = troof.attribute_gaps(flight, spans)
    assert gaps["dispatches"] == 12 and gaps["unsealed"] == 1 and gaps["gaps"]["checkpoint"] > 0
    assert troof.attribute_gaps(flight[:1]) is jroof.attribute_gaps(flight[:1]) is None
    assert troof.latest_cost_by_program(costs) == jroof.latest_cost_by_program(costs)
    assert troof.cost_flops_by_family(costs) == jroof.cost_flops_by_family(costs)
    got = troof.summarize_roofline(costs, flight, "TPU v4", 275.0, trace)
    assert got == jroof.summarize_roofline(costs, flight, "TPU v4", 275.0, trace)
    assert got["machine_balance_flops_per_byte"] == round(275e12 / 1228e9, 4)
    assert troof.summarize_roofline([], [], "cpu") is jroof.summarize_roofline([], [], "cpu") is None
    assert troof.GAP_CATEGORIES == jroof.GAP_CATEGORIES and troof.COST_KIND == jroof.COST_KIND
    for kind in ("TPU v5 lite", "TPU v6e", "cpu", ""):
        assert troof.peak_hbm_gbps_info(kind) == jroof.peak_hbm_gbps_info(kind)


def test_profile_data_spans(tmp_path):
    """A `profile_data/` directory's torch traces give their user
    annotations' spans (the phases and labels), on the trace's base time
    where their times are relative to it; the ops are left out."""
    prof = tmp_path / "profile_data"
    prof.mkdir()
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "phase/fold", "ts": 2e6, "dur": 5e5},
        {"ph": "X", "cat": "user_annotation", "name": "ring.ingest", "ts": 3e6, "dur": 1e5},
        {"ph": "X", "cat": "user_annotation", "name": "phase/checkpoint", "ts": 4e6, "dur": 2e5},
        {"ph": "X", "cat": "cpu_op", "name": "cudaStreamSynchronize", "ts": 2e6, "dur": 1e6},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "phase/fold", "ts": 2e6, "dur": 1e6},
    ]
    (prof / "host_1.1.pt.trace.json").write_text(json.dumps(
        {"traceEvents": events, "baseTimeNanoseconds": 1000 * 10**9}))
    (prof / "phase_timers.json").write_text("{}")
    spans = troof.load_trace_spans(prof)
    assert spans == [("ingest", 1002.0, 1002.5), ("ingest", 1003.0, 1003.1), ("checkpoint", 1004.0, 1004.2)]
    trace = _trace(tmp_path)
    flight = _flight()
    both = troof.summarize_roofline(_costs(), flight, "TPU v4", 275.0, [trace, prof])
    alone = troof.summarize_roofline(_costs(), flight, "TPU v4", 275.0, trace)
    assert both["programs"] == alone["programs"]
    assert both["attribution"] == troof.attribute_gaps(flight, sorted(
        troof.load_trace_spans(trace) + spans, key=lambda s: s[1]))
    assert troof.load_trace_spans(tmp_path / "nothing") == []


def test_h100_bandwidth_table(monkeypatch):
    monkeypatch.delenv(troof.PEAK_HBM_GBPS_ENV, raising=False)
    for kind, gbps in (("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 PCIe", 2000.0),
                       ("NVIDIA H100 NVL", 3900.0)):
        assert troof.peak_hbm_gbps_info(kind) == (gbps, "table")
    from alphatriangle_tpu_torch.utils.flops import peak_bf16_tflops_info

    peak, _ = peak_bf16_tflops_info("NVIDIA H100 80GB HBM3")
    assert troof.machine_balance_flops_per_byte(peak, 3350.0) == pytest.approx(989.4e12 / 3350e9)
    monkeypatch.setenv(troof.PEAK_HBM_GBPS_ENV, "1234")
    assert troof.peak_hbm_gbps_info("NVIDIA H100 80GB HBM3") == (1234.0, "env")


def test_train_run_cost_records_and_cli_roofline(tmp_path, monkeypatch, capsys, tiny_env_config,
                                                 tiny_model_config):
    monkeypatch.setattr(compile_cache, "_global_cache", compile_cache.BuildCache(enabled=True))
    preset = tiny_preset(tmp_path / "p.json", tiny_env_config, tiny_model_config)
    argv = ["train", "--preset", preset, "--device", "cpu", "--root-dir", str(tmp_path), "--run-name", "roof",
            "--max-steps", "2", "--self-play-batch", "2", "--batch-size", "4", "--min-buffer", "4",
            "--buffer-capacity", "64", "--rollout-chunk", "4", "--fused-learner-steps", "2",
            "--no-auto-resume", "--no-tensorboard"]
    assert cli.main(argv) == 0
    capsys.readouterr()
    ledger = tmp_path / "AlphaTriangleTPUTorch" / "runs" / "roof" / "metrics.jsonl"
    costs = {r["program"]: r for r in read_ledger(ledger, kinds={"cost"})}
    assert {"self_play_chunk/t4", "learner_fused_steps"} <= set(costs), sorted(costs)
    env, model = torch_cfg(tiny_env_config), torch_cfg(tiny_model_config)
    fwd = forward_flops(model, env, env.action_dim)
    chunk = costs["self_play_chunk/t4"]
    assert (chunk["origin"], chunk["key"], chunk["backend"]) == ("analytic", "B2xT4", "cpu")
    assert chunk["flops"] == 4 * 2 * (4 + 1) * fwd and chunk["bytes_accessed"] > 0
    learner = costs["learner_fused_steps"]
    assert learner["flops"] == 2 * train_step_flops(model, env, env.action_dim, 4)
    assert chunk["formula"].startswith("flops = T*B*(S+1)*fwd = 4*2*(4+1)*")
    assert learner["formula"].startswith("flops = K*step(b) = 2*")
    assert cli.main(["roofline", str(ledger), "--json"]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jcli.main(["roofline", str(ledger), "--json"]) == 0
    assert ours == json.loads(capsys.readouterr().out)
    programs = {p["program"]: p for p in ours["programs"]}
    assert programs["self_play_chunk/t4"]["flops"] == chunk["flops"] and ours["attribution"]["dispatches"] > 0
    assert cli.main(["roofline", str(ledger)]) == 0
    assert "self_play_chunk/t4" in capsys.readouterr().out
    bare = tmp_path / "bare"
    bare.mkdir()
    MetricsLedger(bare / "metrics.jsonl").append({"kind": "tick", "step": 0, "means": {}})
    assert cli.main(["roofline", str(bare)]) == jcli.main(["roofline", str(bare)]) == 2


def test_cost_bytes_count_each_evaluation_and_step(tiny_env_config, tiny_model_config):
    from alphatriangle_tpu_torch.config import AlphaTriangleMCTSConfig
    from alphatriangle_tpu_torch.env import TriangleEnv
    from alphatriangle_tpu_torch.features import FeatureExtractor
    from alphatriangle_tpu_torch.nn import NeuralNetwork
    from alphatriangle_tpu_torch.rl import SelfPlayEngine, Trainer
    from alphatriangle_tpu_torch.telemetry.memory import tree_bytes

    env_cfg, model_cfg = torch_cfg(tiny_env_config), torch_cfg(tiny_model_config)
    env = TriangleEnv(env_cfg, device="cpu")
    extractor = FeatureExtractor(env, model_cfg)
    net = NeuralNetwork(model_cfg, env_cfg, seed=0, device="cpu")
    # Full searches of 12 simulations in 3 waves of 4, fast ones of 6 in
    # 2 waves of 3 (the largest divisor up to 4), half of each: 2.5
    # waves and the root, 3.5 evaluations a move.
    mcts = AlphaTriangleMCTSConfig(max_simulations=12, mcts_batch_size=4, max_depth=4,
                                   fast_simulations=6, full_search_prob=0.5)
    train = TrainConfig(SELF_PLAY_BATCH_SIZE=2, BATCH_SIZE=8, RUN_NAME="cost")
    engine = SelfPlayEngine(env, extractor, net, mcts, train, seed=0)
    params = sum(p.numel() * p.element_size() for p in net.model.parameters())
    c, h, w = engine._grid_shape
    row = 4 * (c * h * w + extractor.other_dim + env.action_dim + 2)
    flops, nbytes, formula = troof.chunk_cost(engine, 4)
    assert nbytes == 4 * 3.5 * params + 2 * tree_bytes(engine._carry) + 4 * 2 * row
    assert flops == 4 * 2 * (0.5 * 12 + 0.5 * 6 + 1) * forward_flops(model_cfg, env_cfg, env.action_dim)
    assert f"4*3.5*{params}" in formula
    trainer = Trainer(net, train)
    _, one, _ = troof.learner_cost(trainer, 1, 8, row)
    _, four, formula = troof.learner_cost(trainer, 4, 8, row)
    # The parameters and both AdamW moments, read and written each step.
    assert one == 8 * row + 2 * 3 * params and four == 4 * one
    assert formula.endswith(f"= 4*(8*{row} + 2*{3 * params})")


def test_build_cache_counts_hits_and_misses():
    cache = compile_cache.BuildCache(enabled=True)
    tracer = SpanTracer()
    cache.set_tracer(tracer)
    cache.note("miss", "gather_rows", 12.5)
    cache.note("hit", "backup_update", 0.01)
    stats = cache.stats()
    assert (stats["hits"], stats["misses"]) == (1, 1)
    assert [e["event"] for e in stats["events"]] == ["miss", "hit"]
    names = [s[1] for s in tracer._snapshot()]
    assert names == ["compile/gather_rows", "compile/backup_update"]
    rec = troof.program_cost_record("serve/b4", 10, 20, key="b4")
    assert cache.capture_cost(rec) is rec and cache.capture_cost(dict(rec, flops=99)) is rec
    assert cache.cost_summary() == [rec] and cache.cost_record_for("serve/b4", "b4") is rec
    off = compile_cache.BuildCache(enabled=False)
    assert off.capture_cost(rec) is None and off.cost_summary() == []
    # RUN_NAME shapes no program, so it keys nothing.
    assert compile_cache.config_digest(TrainConfig(RUN_NAME="a")) == compile_cache.config_digest(
        TrainConfig(RUN_NAME="b")) != compile_cache.config_digest(TrainConfig(BATCH_SIZE=8))
    assert len(compile_cache.source_digest()) == 16
