"""The port's autotuner (`alphatriangle_tpu_torch/autotune/`) against the
JAX package's (`alphatriangle_tpu/autotune/`), on the CPU. The same
inputs go to both sides and the results are equal exactly:

- `SearchSpace.candidates()` (order, keys, labels), `divisibility_gate`'s
  reasons and `prune_dominated`;
- `predict_throughput` with one explicit `Calibration`, at the smoke
  world of `tests/test_autotune.py` and at the flagship configs (the
  bench plan's and BASELINE presets 3-5);
- `calibration_from_summary`, `merge_calibrations`,
  `cost_anchored_efficiency`, and `calibration_from_targets` over one run
  directory (a ledger with util, cost and `tune_outcome` records and a
  flight ring) that both sides read;
- `run_search` under the same counting oracle: rows, oracle calls,
  evaluations and winner, through the ring prune, the gates, the memo
  and megastep-mode materialization;
- `build_tuned_preset` payloads (but for `created`, `backend` and
  `device_kind`), and each side's `load_tuned_preset` reading the other's.

The flight families the calibration folds are the ones the cost records
key by, so `cost_anchored_efficiency` finds its pairs.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu import autotune as jat  # noqa: E402
from alphatriangle_tpu import config as jconfig  # noqa: E402
from alphatriangle_tpu.autotune import search as jsearch  # noqa: E402
from alphatriangle_tpu_torch import autotune as tat  # noqa: E402
from alphatriangle_tpu_torch import config as tconfig  # noqa: E402
from alphatriangle_tpu_torch.autotune import search as tsearch  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import torch_cfg  # noqa: E402


def _smoke_world():
    """The perf-smoke world of `tests/test_autotune.py` (JAX configs)."""
    env = jconfig.EnvConfig(
        ROWS=3, COLS=4, PLAYABLE_RANGE_PER_ROW=[(0, 4), (0, 4), (0, 4)], NUM_SHAPE_SLOTS=1,
        MAX_SHAPE_TRIANGLES=3, LINE_MIN_LENGTH=3,
    )
    model = jconfig.ModelConfig(
        GRID_INPUT_CHANNELS=1, CONV_FILTERS=[4], CONV_KERNEL_SIZES=[3], CONV_STRIDES=[1],
        NUM_RESIDUAL_BLOCKS=0, RESIDUAL_BLOCK_FILTERS=4, USE_TRANSFORMER=False,
        FC_DIMS_SHARED=[16], POLICY_HEAD_DIMS=[16], VALUE_HEAD_DIMS=[16],
        OTHER_NN_INPUT_FEATURES_DIM=jconfig.expected_other_features_dim(env),
        NUM_VALUE_ATOMS=11, COMPUTE_DTYPE="float32",
    )
    mcts = jconfig.AlphaTriangleMCTSConfig(max_simulations=4, max_depth=4)
    return env, model, mcts


def _flagship_world():
    """The bench plan's flagship configs (the port's `cuda` scale; building
    them needs no card), as JAX configs."""
    from alphatriangle_tpu_torch.bench_config import resolve_bench_plan

    plan = resolve_bench_plan(False, "cuda", environ={})
    return (
        jconfig.EnvConfig(**plan.env.model_dump()),
        jconfig.ModelConfig(**plan.model.model_dump()),
        jconfig.AlphaTriangleMCTSConfig(**plan.mcts.model_dump()),
    )


def _preset_world(n: int):
    bundle = jconfig.baseline_preset(n)
    return bundle["env"], bundle["model"], bundle["mcts"]


WORLDS = {
    "smoke": _smoke_world,
    "flagship": _flagship_world,
    **{f"preset{n}": (lambda n=n: _preset_world(n)) for n in (3, 4, 5)},
}


def _both(jcfgs):
    return jcfgs, tuple(torch_cfg(c) for c in jcfgs)


def _port_candidate(c):
    return tat.Candidate(**dataclasses.asdict(c))


def _jax_train(**kw):
    base = dict(
        BATCH_SIZE=4, BUFFER_CAPACITY=64, MIN_BUFFER_SIZE_TO_TRAIN=8, SELF_PLAY_BATCH_SIZE=4,
        ROLLOUT_CHUNK_MOVES=4, AUTO_RESUME_LATEST=False, RUN_NAME="tune_test",
    )
    base.update(kw)
    return jconfig.TrainConfig(**base)


SPACES = {
    "default": {},
    "axes": dict(
        geometries=["plan", "tiny"], batches=[16, 4, 8, 8], capacities=[128, 64], chunks=[4, 2],
        fused_ks=[2], dps=[1, 2, 3], descent_gathers=["einsum", "take"],
        backup_updates=["xla", "pallas"], per_samples=["pallas"], precisions=["float32", "bfloat16"],
        serve_bucket_ladders=["", "4,8"], tree_reuses=[False, True],
    ),
}


class TestSpace:
    @pytest.mark.parametrize("name", sorted(SPACES))
    def test_candidates_keys_and_labels(self, name):
        js, ts = jat.SearchSpace(**SPACES[name]), tat.SearchSpace(**SPACES[name])
        jc, tc = js.candidates(), ts.candidates()
        assert [dataclasses.astuple(c) for c in tc] == [dataclasses.astuple(c) for c in jc]
        assert ts.size() == js.size() == len(tc)
        for a, b in zip(jc, tc):
            assert (b.group_key(), b.oracle_key(), b.kernels(), b.label()) == (
                a.group_key(), a.oracle_key(), a.kernels(), a.label()
            )

    @pytest.mark.parametrize("axes, lbatch, min_buffer", [
        (dict(sp_batch=0), 4, 8),
        (dict(capacity=2), 4, 1),
        (dict(capacity=6), 4, 8),
        (dict(dp=2, capacity=63), 4, 8),
        (dict(dp=2), 5, 8),
        (dict(dp=4, sp_batch=6), 4, 8),
        (dict(dp=2), 4, 8),
        (dict(), 4, 8),
    ])
    def test_divisibility_gate(self, axes, lbatch, min_buffer):
        kw = dict(geometry="plan", sp_batch=8, capacity=64, chunk=4, fused_k=2, dp=1)
        kw.update(axes)
        jc = jat.Candidate(**kw)
        assert tat.divisibility_gate(_port_candidate(jc), lbatch, min_buffer) == \
            jat.divisibility_gate(jc, lbatch, min_buffer)

    def test_prune_dominated(self):
        space = SPACES["axes"]
        jc = jat.SearchSpace(**space).candidates()
        feasible = {c for c in jc if c.sp_batch == 8 and c.dp != 3}
        want = jat.prune_dominated(jc, feasible)
        got = tat.prune_dominated([_port_candidate(c) for c in jc],
                                  {_port_candidate(c) for c in feasible})
        assert {dataclasses.astuple(c): s for c, s in got.items()} == \
            {dataclasses.astuple(c): s for c, s in want.items()}
        assert got


CALIBRATIONS = [
    dict(),
    dict(efficiency=0.031, moves_per_game=17.5, overhead_s=0.004, outcome_scale=0.8),
]


class TestModel:
    @pytest.mark.parametrize("world", sorted(WORLDS))
    @pytest.mark.parametrize("megastep", [False, True])
    @pytest.mark.parametrize("cal", range(len(CALIBRATIONS)))
    def test_predict_throughput(self, world, megastep, cal):
        (jenv, jmodel, jmcts), (tenv, tmodel, tmcts) = _both(WORLDS[world]())
        jcal, tcal = jat.Calibration(**CALIBRATIONS[cal]), tat.Calibration(**CALIBRATIONS[cal])
        for b, t, k, dp, peak, lbatch in ((4, 4, 2, 1, None, 8), (512, 16, 16, 1, 989.4, 256),
                                          (1024, 8, 4, 2, 459.0, 7)):
            jc = jat.Candidate(geometry="plan", sp_batch=b, capacity=2000, chunk=t, fused_k=k, dp=dp)
            want = jat.predict_throughput(jc, jenv, jmodel, jmcts, lbatch, calibration=jcal,
                                          peak_tflops=peak, megastep=megastep)
            got = tat.predict_throughput(_port_candidate(jc), tenv, tmodel, tmcts, lbatch,
                                         calibration=tcal, peak_tflops=peak, megastep=megastep)
            assert got == want
        assert tat.expected_simulations(tmcts) == jat.expected_simulations(jmcts)
        assert tat.default_moves_per_game(tenv) == jat.default_moves_per_game(jenv)

    @pytest.mark.parametrize("summary", [
        {"mfu": 0.02, "moves_per_sec": 100.0, "games_per_hour": 9000.0, "source": "a"},
        {"mfu": 1.5, "moves_per_sec": 100.0, "games_per_hour": 9000.0},
        {"mfu": 0.0, "moves_per_sec": 0.0, "games_per_hour": 10.0},
        {"moves_per_sec": 12.0, "games_per_hour": 3.0},
        {"mfu": 0.5},
        {},
        "not a dict",
    ])
    def test_calibration_from_summary(self, summary):
        want = jat.calibration_from_summary(summary)
        got = tat.calibration_from_summary(summary)
        assert (got is None) == (want is None)
        if want is not None:
            assert got.as_dict() == want.as_dict()

    def test_merge_calibrations(self):
        parts = [
            dict(efficiency=0.02, moves_per_game=10.0, outcome_scale=0.5,
                 family_seconds={"rollout": 1.0, "learner": 0.5}, cost_flops={"rollout": 1e12},
                 sources=["a", "flight x2"]),
            dict(efficiency=0.04, moves_per_game=None, overhead_s=0.02, outcome_scale=1.5,
                 family_seconds={"rollout": 3.0, "megastep": "torn"}, cost_flops={"learner": 2e9},
                 sources=["b"]),
            dict(),
        ]
        for k in range(len(parts) + 1):
            want = jat.merge_calibrations([jat.Calibration(**p) for p in parts[:k]] + ["junk"])
            got = tat.merge_calibrations([tat.Calibration(**p) for p in parts[:k]] + ["junk"])
            assert got.as_dict() == want.as_dict()

    @pytest.mark.parametrize("cost, secs, peak", [
        ({"rollout": 1e12, "learner": 5e11}, {"rollout": 2.0, "learner": 0.1}, 989.4),
        ({"rollout": 1e18}, {"rollout": 0.001}, 989.4),
        ({"rollout": 1e12}, {"learner": 1.0}, 989.4),
        ({"rollout": 1e12}, {"rollout": 1.0}, None),
        ({"rollout": -1.0, "serve": 4e9}, {"rollout": 1.0, "serve": 0.5}, 0.5),
        ({}, {}, 1.0),
    ])
    def test_cost_anchored_efficiency(self, cost, secs, peak):
        assert tat.model.cost_anchored_efficiency(cost, secs, peak) == \
            jat.model.cost_anchored_efficiency(cost, secs, peak)

    def test_calibration_from_targets(self, tmp_path):
        """One run directory written once, read by both sides: its util
        records, cost records (the port's program names), two
        `tune_outcome` records and a flight ring of sealed dispatches."""
        run = tmp_path / "run"
        run.mkdir()
        records = [
            {"kind": "util", "step": s, "time": 100.0 + s, "moves_per_sec": 40.0 + s,
             "games_per_hour": 900.0 + 10 * s, "mfu": 0.012 + 0.001 * s, "peak_bf16_tflops": 989.4}
            for s in range(1, 4)
        ]
        records += [
            {"kind": "cost", "category": "program", "component": f"program/{p}", "program": p,
             "key": "", "backend": "cuda", "origin": "analytic", "flops": f, "bytes_accessed": 1e9,
             "transcendentals": None, "time": 50.0}
            for p, f in (("self_play_chunk/t2", 3.2e13), ("megastep/t2_k2", 3.5e13),
                         ("learner_fused/k2", 1.1e11), ("learner_step/b256", 5e10))
        ]
        records += [
            {"kind": "tune_outcome", "time": 200.0, "observed_over_predicted": 0.25},
            {"kind": "tune_outcome", "time": 201.0, "observed_over_predicted": 0.75},
            {"kind": "tune_outcome", "time": 202.0, "observed_over_predicted": None},
        ]
        (run / "metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in records))
        flight = []
        for seq, (family, program, wall) in enumerate((
            ("rollout", "self_play_chunk/t2", 1.5), ("rollout", "self_play_chunk/t2", 2.5),
            ("megastep", "megastep/t2_k2", 1.25), ("learner", "learner_fused/k2", 0.05),
            ("learner", "learner_fused/k2", 0.07), ("learner", "learner_fused/k2", 0.06),
        ), start=1):
            flight.append({"kind": "flight", "phase": "intent", "seq": seq, "program": program,
                           "family": family, "t_mono": float(seq), "time": 100.0 + seq})
            flight.append({"kind": "flight", "phase": "seal", "seq": seq, "program": program,
                           "family": family, "wall_s": wall, "ok": True, "t_mono": seq + wall,
                           "time": 100.0 + seq + wall})
        flight.append({"kind": "flight", "phase": "seal", "seq": 99, "program": "serve/b64",
                       "family": "serve", "wall_s": 9.0, "ok": False})
        (run / "flight.jsonl").write_text("".join(json.dumps(r) + "\n" for r in flight))

        for targets in ([str(run)], [str(run / "metrics.jsonl"), str(tmp_path / "missing")], []):
            want = jat.calibration_from_targets(targets)
            got = tat.calibration_from_targets(targets)
            assert got.as_dict() == want.as_dict()
        cal = tat.calibration_from_targets([str(run)])
        assert "tune_outcome x2" in cal.sources and "efficiency<-cost_flops" in cal.sources
        assert cal.outcome_scale == pytest.approx(0.5)

    def test_flight_families_are_the_cost_families(self):
        """The dispatch sites' families (`rl/self_play.py`, `rl/megastep.py`,
        `rl/trainer.py`, `serving/service.py`) are `program_family` of
        their program names, the keys `cost_flops_by_family` gives."""
        from alphatriangle_tpu_torch.telemetry.flight import family_seconds, program_family

        for family, program in (("rollout", "self_play_chunk/t16"), ("megastep", "megastep/t2_k2"),
                                ("learner", "learner_fused/k16"), ("learner", "learner_step/b256"),
                                ("serve", "serve/b64")):
            assert program_family(program) == family
        seals = [{"phase": "seal", "family": "rollout", "wall_s": w, "ok": True} for w in (1.0, 3.0, 2.0)]
        from alphatriangle_tpu.telemetry.flight import family_seconds as jfamily_seconds

        assert family_seconds(seals) == jfamily_seconds(seals) == {"rollout": 2.0}


class _CountingOracle:
    """Fits iff sp_batch <= max_b; its budget is B bytes a lane; counts
    its calls."""

    def __init__(self, max_b: int, bytes_per_lane: int = 1000):
        self.max_b = max_b
        self.bytes_per_lane = bytes_per_lane
        self.calls: list = []

    def __call__(self, cand, env, model, train, limit):
        self.calls.append(cand.label())
        return cand.sp_batch <= self.max_b, {"total_bytes": cand.sp_batch * self.bytes_per_lane}, []


SEARCHES = {
    # The dominance walk: B descending, the first fit wins its group.
    "dominance": (dict(batches=[4, 8, 16], capacities=[64], chunks=[4], fused_ks=[2]), {}, 8,
                  10**9, "sync"),
    # Two capacities, the larger one's ring alone over the limit.
    "ring": (dict(batches=[4, 8], capacities=[64, 10**6], chunks=[4], fused_ks=[2]), {}, 8,
             2 * 10**6, "sync"),
    # Gates: a capacity under the learner batch, dp widths that do not divide.
    "gates": (dict(batches=[6, 8], capacities=[2, 64, 66], chunks=[4], fused_ks=[2], dps=[1, 2, 4]),
              {}, 8, 10**9, "sync"),
    # Nothing fits.
    "none": (dict(batches=[8, 16], capacities=[64], chunks=[2, 4], fused_ks=[1, 2]), {}, 4,
             10**9, "sync"),
    # Megastep mode over the kernel axes: the memo shares answers over the
    # memory-neutral axes; a named geometry re-derives the feature width.
    "megastep": (dict(geometries=["plan", "tiny"], batches=[4, 8], capacities=[64], chunks=[4],
                      fused_ks=[2], backup_updates=["xla", "pallas"], per_samples=["xla", "pallas"],
                      precisions=["float32", "bfloat16"], serve_bucket_ladders=["", "4,8"],
                      tree_reuses=[False, True]),
                 dict(BATCH_SIZE=4), 4, 10**9, "megastep"),
    # A calibrated search at the flagship world's net.
    "calibrated": (dict(batches=[2, 4, 8], capacities=[64, 128], chunks=[2, 4], fused_ks=[1, 2]),
                   {}, 4, 10**9, "sync"),
}


def _search(pkg, search_name, jworld):
    space_kw, train_kw, max_b, limit, mode = SEARCHES[search_name]
    env, model, mcts = jworld
    train = _jax_train(**train_kw)
    if pkg is tat:
        env, model, mcts, train = (torch_cfg(c) for c in (env, model, mcts, train))
    cal = pkg.Calibration(efficiency=0.02, moves_per_game=9.0) if search_name == "calibrated" else None
    oracle = _CountingOracle(max_b)
    result = pkg.run_search(pkg.SearchSpace(**space_kw), env, model, mcts, train, limit,
                            calibration=cal, peak_tflops=989.4 if cal else None, mode=mode,
                            oracle=oracle)
    return result, oracle, (env, model, mcts, train, mode)


class TestRunSearch:
    @pytest.mark.parametrize("name", sorted(SEARCHES))
    def test_rows_calls_and_winner(self, name, tiny_env_config, tiny_model_config,
                                   tiny_mcts_config):
        world = (_flagship_world() if name == "calibrated"
                 else (tiny_env_config, tiny_model_config, tiny_mcts_config))
        want, jo, _ = _search(jat, name, world)
        got, to, _ = _search(tat, name, world)
        assert got.rows == want.rows
        assert (got.oracle_calls, got.evaluated, to.calls) == (want.oracle_calls, want.evaluated, jo.calls)
        assert (got.best is None) == (want.best is None)
        if want.best is not None:
            assert dataclasses.astuple(got.best) == dataclasses.astuple(want.best)
            assert (got.best_prediction, got.best_budget) == (want.best_prediction, want.best_budget)
        assert len(got.feasible_rows()) == len(want.feasible_rows())
        assert got.limit_bytes == want.limit_bytes
        if name == "ring":
            assert {r["status"] for r in got.rows if r["capacity"] == 10**6} == {"ring-over"}

    def test_megastep_materialization(self, tiny_env_config, tiny_model_config):
        """A candidate's configs in megastep mode (the fused, device-ring
        train config) and at a named geometry, field for field."""
        jtrain = _jax_train(BATCH_SIZE=4)
        ttrain, tenv, tmodel = (torch_cfg(c) for c in (jtrain, tiny_env_config, tiny_model_config))
        for kw in (dict(geometry="plan"), dict(geometry="tiny", inference_precision="bfloat16"),
                   dict(geometry="default", per_sample="pallas")):
            jc = jat.Candidate(**{**dict(sp_batch=8, capacity=32, chunk=2, fused_k=3, dp=1), **kw})
            for mode in ("sync", "megastep"):
                want = jsearch.materialize_candidate(jc, tiny_env_config, tiny_model_config, jtrain, mode)
                got = tsearch.materialize_candidate(_port_candidate(jc), tenv, tmodel, ttrain, mode)
                assert [c.model_dump() for c in got] == [c.model_dump() for c in want]
                assert tsearch.ring_bytes_for(_port_candidate(jc), got[0], got[1]) == \
                    jsearch.ring_bytes_for(jc, want[0], want[1])


class TestArtifact:
    def _payloads(self, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config):
        out = {}
        for pkg in (jat, tat):
            result, _, (env, model, mcts, train, mode) = _search(
                pkg, "megastep", (tiny_env_config, tiny_model_config, tiny_mcts_config)
            )
            smod = jsearch if pkg is jat else tsearch
            env, model, train = smod.materialize_candidate(result.best, env, model, train, mode)
            train = train.model_copy(update={"RUN_NAME": "tuned_rt"})
            payload = pkg.build_tuned_preset(
                result, env, model, smod.candidate_mcts(mcts, result.best), train, scale="cpu",
                mode=mode, backend="cpu" if pkg is jat else "cuda",
                device_kind="cpu" if pkg is jat else "NVIDIA H100 80GB HBM3", limit_bytes=10**9,
                limit_source="flag", calibration=pkg.Calibration(sources=["defaults", "x"]),
                run_name="tuned_rt",
            )
            name = "jax" if pkg is jat else "port"
            out[name] = (payload, pkg.write_tuned_preset(payload, tmp_path / name / "tuned_preset.json"))
        return out

    def test_payloads_equal(self, tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config):
        out = self._payloads(tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config)
        skip = {"created", "backend", "device_kind", "description"}
        jp, tp = out["jax"][0], out["port"][0]
        assert {k: v for k, v in tp.items() if k not in skip} == \
            {k: v for k, v in jp.items() if k not in skip}
        assert tp["description"] == jp["description"].replace(
            "on cpu/cpu", "on cuda/NVIDIA H100 80GB HBM3"
        )
        assert tp["schema"] == tconfig.TUNED_PRESET_SCHEMA == jconfig.TUNED_PRESET_SCHEMA
        with pytest.raises(ValueError, match="feasible winner"):
            tat.build_tuned_preset(tat.TuneResult(), *[None] * 4, scale="", mode="", backend="",
                                   device_kind="", limit_bytes=None, limit_source="",
                                   calibration=None, run_name="")

    def test_presets_load_across_packages(self, tmp_path, tiny_env_config, tiny_model_config,
                                          tiny_mcts_config):
        out = self._payloads(tmp_path, tiny_env_config, tiny_model_config, tiny_mcts_config)
        for name in ("jax", "port"):
            path = out[name][1]
            jb, tb = jconfig.load_tuned_preset(path), tconfig.load_tuned_preset(path)
            for key in ("env", "model", "train", "mcts"):
                assert tb[key].model_dump() == torch_cfg(jb[key]).model_dump()
            assert tb["train"].FUSED_MEGASTEP and tb["train"].RUN_NAME == "tuned_rt"
            assert tb["tuned"] == jb["tuned"]

    def test_default_artifact_path(self, tmp_path):
        path = tat.default_artifact_path("t", root_dir=tmp_path)
        assert path == tmp_path / tconfig.APP_NAME / "runs" / "t" / "tuned_preset.json"
        jpath = jat.default_artifact_path("t", root_dir=tmp_path)
        assert (path.name, path.parent.name) == (jpath.name, jpath.parent.name)
