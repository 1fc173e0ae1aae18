"""The port's `cli tune` against the JAX package's, on the CPU.

- `tune cpu --smoke` with the oracle faked out the same way on both
  sides: the same exit codes and the same rows, in either loop mode and
  over a wider pinned space;
- exit 1 under `--limit-gb 0.000001` (every candidate's ring alone is
  over: no oracle call), exit 2 with no limit known;
- one run of the real oracle on the CPU at a one-candidate smoke space:
  the programs run and the budget is the static records (the CPU has no
  allocator statistics, `telemetry/memory.estimate_fit`); the artifact
  loads in both packages;
- the device rule: `--device cuda` (or `auto`, or no flag) without a card
  fails and says so; nothing falls back to the CPU.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu import cli as jcli  # noqa: E402
from alphatriangle_tpu.autotune import search as jsearch  # noqa: E402
from alphatriangle_tpu.config import load_tuned_preset as jload  # noqa: E402
from alphatriangle_tpu.telemetry import health as jhealth  # noqa: E402
from alphatriangle_tpu.telemetry import memory as jmem  # noqa: E402
from alphatriangle_tpu_torch import cli  # noqa: E402
from alphatriangle_tpu_torch.autotune import search as tsearch  # noqa: E402
from alphatriangle_tpu_torch.config import load_tuned_preset  # noqa: E402
from alphatriangle_tpu_torch.telemetry import memory as tmem  # noqa: E402
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)


def _fake_default_oracle(max_b: int, calls: list):
    """A `default_oracle` stand-in for both packages: fits iff B <= max_b,
    a budget of 1000 bytes a lane; records each call's candidate."""

    def make(mcts, mode, device_replay=None, progress=None, device=None):
        def oracle(cand, env, model, train, limit):
            calls.append((mode, cand.label()))
            return cand.sp_batch <= max_b, {"total_bytes": 1000 * cand.sp_batch}, []

        return oracle

    return make


def _report(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _run_both(monkeypatch, capsys, tmp_path, argv: list, max_b: "int | None" = None) -> tuple:
    """(JAX (rc, report, calls), port (rc, report, calls)) of one command
    line; `max_b` None keeps the real oracles (the ring prune must stop
    every candidate first)."""
    out = []
    for name, mod, search in (("jax", jcli, jsearch), ("port", cli, tsearch)):
        calls: list = []
        if max_b is not None:
            monkeypatch.setattr(search, "default_oracle", _fake_default_oracle(max_b, calls))
        extra = ["--out", str(tmp_path / name / "tuned_preset.json"), "--root-dir", str(tmp_path / name)]
        extra += [] if name == "jax" else ["--device", "cpu"]
        rc = mod.main(["tune", *argv, "--json", *extra])
        out.append((rc, _report(capsys), calls))
    return tuple(out)


CASES = {
    "smoke-fits": (["cpu", "--smoke", "--limit-gb", "8"], 10**6, 0),
    "smoke-none-fit": (["cpu", "--smoke", "--limit-gb", "8"], 1, 1),
    "smoke-megastep": (["cpu", "--smoke", "--limit-gb", "8", "--mode", "megastep"], 8, 0),
    "pinned": (["cpu", "--smoke", "--limit-gb", "8", "--batches", "4,8,16,32", "--capacities",
                "10000,20000", "--chunks", "2,4", "--fused-k", "2", "--kernel-backends", "xla,pallas",
                "--precisions", "float32,bfloat16", "--serve-buckets", "off", "--serve-buckets", "4,8",
                "--tree-reuse", "off,on", "--dp", "1,2"], 8, 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rows_and_exit_codes_equal_jax(name, monkeypatch, capsys, tmp_path):
    argv, max_b, want_rc = CASES[name]
    (jrc, jrep, jcalls), (trc, trep, tcalls) = _run_both(monkeypatch, capsys, tmp_path, argv, max_b)
    assert trc == jrc == want_rc
    assert trep["rows"] == jrep["rows"]
    assert tcalls == jcalls and trep["oracle_calls"] == jrep["oracle_calls"] == len(tcalls)
    for key in ("schema", "scale", "mode", "bytes_limit", "limit_source", "exit"):
        assert trep[key] == jrep[key], key
    assert (trep["backend"], jrep["backend"]) == ("cpu", "cpu")
    assert trep["oracle"] == []  # the fake keeps no accounts
    if want_rc == 0:
        skip = {"created", "description", "device_kind"}
        assert {k: v for k, v in trep["best"].items() if k not in skip} == \
            {k: v for k, v in jrep["best"].items() if k not in skip}
        assert load_tuned_preset(trep["artifact"])["tuned"]["candidate"] == \
            jload(jrep["artifact"])["tuned"]["candidate"]
    else:
        assert trep["best"] is None and jrep["best"] is None


def test_text_table_equals_jax(monkeypatch, capsys, tmp_path):
    """Without --json: the same table and lines, but for the artifact's
    path."""
    texts = []
    for name, mod, search in (("jax", jcli, jsearch), ("port", cli, tsearch)):
        monkeypatch.setattr(search, "default_oracle", _fake_default_oracle(8, []))
        out = tmp_path / "tuned_preset.json"
        extra = [] if name == "jax" else ["--device", "cpu"]
        assert mod.main(["tune", "cpu", "--smoke", "--limit-gb", "8", "--out", str(out), *extra]) == 0
        texts.append(capsys.readouterr().out.splitlines())
    jtext, ttext = texts
    assert ttext[:-1] == jtext[:-1]
    assert ttext[-1].startswith("tune: consume with `cli train --preset ")


def test_limit_below_every_ring_exits_1(monkeypatch, capsys, tmp_path):
    (jrc, jrep, _), (trc, trep, _) = _run_both(
        monkeypatch, capsys, tmp_path, ["cpu", "--smoke", "--limit-gb", "0.000001"]
    )
    assert trc == jrc == 1
    assert trep["rows"] == jrep["rows"] and trep["oracle_calls"] == jrep["oracle_calls"] == 0
    assert {r["status"] for r in trep["rows"]} == {"ring-over"}


def test_no_limit_known_exits_2(monkeypatch, capsys, tmp_path):
    monkeypatch.delenv(tmem.BYTES_LIMIT_ENV, raising=False)
    monkeypatch.delenv(jmem.BYTES_LIMIT_ENV, raising=False)
    monkeypatch.setattr(jhealth, "device_memory_stats", lambda: [])
    assert jcli.main(["tune", "cpu", "--smoke", "--root-dir", str(tmp_path)]) == 2
    assert cli.main(["tune", "cpu", "--smoke", "--root-dir", str(tmp_path)]) == 2
    assert "no per-device byte limit known" in capsys.readouterr().err
    monkeypatch.setenv(tmem.BYTES_LIMIT_ENV, "1000")
    assert cli.main(["tune", "cpu", "--smoke", "--json", "--root-dir", str(tmp_path)]) == 1
    rep = _report(capsys)
    assert (rep["limit_source"], rep["bytes_limit"]) == ("env", 1000.0)


def test_real_oracle_on_the_cpu(capsys, tmp_path):
    """One candidate through `estimate_fit`: its chunk and fused learner
    group run on the CPU, no allocator statistics, so the budget is the
    static records (the learner state; the host ring is not counted)."""
    from alphatriangle_tpu_torch.autotune.search import materialize_candidate
    from alphatriangle_tpu_torch.bench_config import resolve_bench_plan
    from alphatriangle_tpu_torch.warm import plan_programs

    rc = cli.main(["tune", "cpu", "--smoke", "--device", "cpu", "--limit-gb", "8", "--batches", "8",
                   "--json", "--run-name", "t", "--root-dir", str(tmp_path)])
    err = capsys.readouterr()
    rep = json.loads(err.out.strip().splitlines()[-1])
    assert rc == 0 and rep["oracle_calls"] == 1 and rep["mode"] == "sync"
    assert "fit: self_play_chunk/t4: ran" in err.err and "fit: learner_fused/k4: ran" in err.err
    assert "learner_step" not in err.err and "megastep" not in err.err
    (row,) = rep["rows"]
    (call,) = rep["oracle"]
    assert row["status"] == "fit" and call["fits"] and call["oom"] is None
    assert call["device"] == "cpu" and call["allocated_before"] is None and call["seconds"] > 0
    assert rep["kernel_launches"] == {k: 0 for k in rep["kernel_launches"]}

    plan = resolve_bench_plan(True, "cpu", environ={})
    cand = tsearch.Candidate(geometry="plan", sp_batch=8, capacity=plan.train.BUFFER_CAPACITY,
                             chunk=plan.chunk, fused_k=plan.fused_k, dp=1)
    env, model, train = materialize_candidate(cand, plan.env, plan.model, plan.train, "sync")
    plan.train, plan.sp_batch = train, 8
    static, _ = plan_programs(plan, "cpu", serve=False, megastep=False)
    assert row["budget_total_bytes"] == call["budget_total_bytes"] == \
        tmem.compose_budget(static)["total_bytes"] > 0
    path = tmp_path / "AlphaTriangleTPUTorch" / "runs" / "t" / "tuned_preset.json"
    assert rep["artifact"] == str(path)
    lanes = (jload(path)["train"].SELF_PLAY_BATCH_SIZE, load_tuned_preset(path)["train"].SELF_PLAY_BATCH_SIZE)
    assert lanes == (8, 8)
    assert rep["best"]["backend"] == "cpu" and rep["best"]["device_kind"] == "cpu"


@pytest.mark.parametrize("argv", [
    ["tune", "smoke", "--limit-gb", "8"],
    ["tune", "smoke", "--limit-gb", "8", "--device", "cuda"],
    ["tune", "cpu", "--limit-gb", "8", "--device", "auto"],
])
def test_tune_needs_a_card_unless_told_cpu(argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([*argv, "--root-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
