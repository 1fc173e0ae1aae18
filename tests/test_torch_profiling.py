"""The port's profiling plane (`profiling.py`, `cli train --profile`,
`cli analyze`) against the JAX package's.

`PhaseTimers` and `ProfileSession` keep the JAX contracts: locked
accumulation from many threads, the trace window [start, stop) and its
`ValueError`, a window the run ended inside stopped by `close()`. A
tiny `cli train --profile`, the port's and the JAX package's on the
same tuned-preset artifact and flags, dumps phase timers with the same
phase names and counts (the times differ): the synchronous loop here,
the megastep and the overlapped loop in `test_torch_profile_megastep.py`
and `test_torch_profile_async.py` (`assert_phases_match` says what each
compares). The batches are multiples of 8, which the JAX learner needs
under the suite's 8 virtual CPU devices. `cli analyze` prints the table
and the trace's lines (exit 0) and exits 1 on an empty directory.
"""

import json
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from alphatriangle_tpu import cli as jcli  # noqa: E402
from alphatriangle_tpu_torch import cli  # noqa: E402
from alphatriangle_tpu_torch.profiling import (  # noqa: E402
    PhaseTimers,
    ProfileSession,
    summarize_chrome_trace,
)
from torch_parity import plain_jax_programs  # noqa: E402, F401 (autouse)
from torch_parity import tiny_preset  # noqa: E402

PORT_APP, JAX_APP = "AlphaTriangleTPUTorch", "AlphaTriangleTPU"
MODES = {
    "sync": [],
    "megastep": ["--fused-megastep", "--device-replay", "on", "--fused-learner-steps", "2"],
    "async": ["--async-rollouts", "--workers", "1"],
}


def test_phase_timers_lose_nothing_under_threads():
    timers = PhaseTimers()
    threads, per_thread = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(per_thread):
                with timers.phase(f"enqueue_wait/stream{i % 2}"):
                    pass
                with timers.phase("rollout"):
                    pass

        pool = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    summary = timers.summary()
    assert summary["rollout"]["count"] == threads * per_thread
    assert summary["enqueue_wait/stream0"]["count"] == summary["enqueue_wait/stream1"]["count"] == (
        threads * per_thread // 2
    )
    assert set(timers.metrics()) == {
        "Profile/rollout_ms", "Profile/enqueue_wait/stream0_ms", "Profile/enqueue_wait/stream1_ms",
    }
    try:
        with timers.phase("boom"):
            raise RuntimeError
    except RuntimeError:
        pass
    assert timers.summary()["boom"]["count"] == 1


def test_profile_session_window(tmp_path):
    with pytest.raises(ValueError, match="trace_stop"):
        ProfileSession(True, tmp_path / "p", trace_start=2, trace_stop=2)
    off = ProfileSession(False, tmp_path / "off")
    for i in range(3):
        off.on_iteration(i)
        with off.phase("rollout"):
            pass
    off.close()
    assert not (tmp_path / "off").exists() and off.timers.summary()["rollout"]["count"] == 3

    spans = []
    tracer = type("T", (), {"complete": lambda self, name, b, e: spans.append((name, e >= b))})()
    s = ProfileSession(True, tmp_path / "p", trace_start=1, trace_stop=3, tracer=tracer)
    tracing = []
    for i in range(5):
        s.on_iteration(i)
        tracing.append(s.tracing)
        with s.phase("rollout"):
            torch.ones(64).cumsum(0)
    s.close()
    assert tracing == [False, True, True, False, False]
    assert spans == [("rollout", True)] * 5
    assert json.loads((tmp_path / "p" / "phase_timers.json").read_text())["rollout"]["count"] == 5
    lines = summarize_chrome_trace(s.trace_path)
    host = {ln["line"].split()[-1]: ln for ln in lines if ln["plane"] == "host"}
    # The window held iterations 1-2: two phase labels, their ops inside.
    assert next(o for o in host["user_annotation"]["ops"] if o["name"] == "phase/rollout")["count"] == 2
    assert any(o["name"] == "aten::cumsum" for o in host["cpu_op"]["ops"])
    for ln in lines:
        assert abs(sum(o["share"] for o in ln["ops"]) - 1.0) < 1e-9

    # A window the run ends inside is stopped and exported by close().
    open_end = ProfileSession(True, tmp_path / "q", trace_start=0, trace_stop=99)
    open_end.on_iteration(0)
    assert open_end.tracing
    open_end.close()
    assert not open_end.tracing and open_end.trace_path.exists()


def test_trace_summary_counts_nested_ranges_once(tmp_path):
    """Self time on a host thread: a range's children are taken out of
    it, so the line sums to the outer range's wall; device lines are
    summed per stream."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "outer", "pid": 1, "tid": 7, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "inner", "pid": 1, "tid": 7, "ts": 10, "dur": 30},
        {"ph": "X", "cat": "user_annotation", "name": "inner", "pid": 1, "tid": 7, "ts": 50, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "gather_rows_kernel", "pid": 0, "tid": 7, "ts": 5, "dur": 4},
        {"ph": "X", "cat": "kernel", "name": "gather_rows_kernel", "pid": 0, "tid": 7, "ts": 15, "dur": 4},
        {"ph": "X", "cat": "kernel", "name": "backup_update_kernel", "pid": 0, "tid": 9, "ts": 15, "dur": 2},
        {"ph": "i", "cat": "kernel", "name": "instant", "pid": 0, "tid": 7, "ts": 1},
        {"ph": "X", "cat": "ac2g", "name": "flow", "pid": 0, "tid": 7, "ts": 1, "dur": 1},
    ]
    path = tmp_path / "x.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    lines = {(ln["plane"], ln["line"]): ln for ln in summarize_chrome_trace(path)}
    assert list(lines)[:2] == [("device 0", "stream 7"), ("device 0", "stream 9")]
    s7 = lines[("device 0", "stream 7")]
    assert s7["total_us"] == 8 and s7["ops"] == [
        {"name": "gather_rows_kernel", "total_us": 8.0, "count": 2, "share": 1.0}
    ]
    host = lines[("host", "thread 7 user_annotation")]
    assert host["total_us"] == 100.0
    assert {o["name"]: (o["total_us"], o["count"]) for o in host["ops"]} == {
        "outer": (50.0, 1), "inner": (50.0, 2),
    }


def test_cli_analyze_exit_codes_and_output(tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main(["analyze", str(empty)]) == jcli.main(["analyze", str(empty)]) == 1
    capsys.readouterr()
    s = ProfileSession(True, tmp_path / "p", trace_start=0, trace_stop=1)
    s.on_iteration(0)
    with s.phase("megastep"):
        torch.ones(8).sum()
    with s.phase("checkpoint"):
        pass
    s.on_iteration(1)
    s.close()
    assert cli.main(["analyze", str(tmp_path / "p"), "--top", "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["phase", "total", "s", "count", "mean", "ms"]
    assert [ln.split()[0] for ln in out[1:3]] == ["megastep", "checkpoint"]
    assert "1 trace(s):" in out and any("user_annotation" in ln for ln in out)
    # Only the dump: the JAX analyzer prints the same table.
    s.trace_path.unlink()
    assert cli.main(["analyze", str(tmp_path / "p")]) == 0
    ours = capsys.readouterr().out
    assert jcli.main(["analyze", str(tmp_path / "p")]) == 0
    assert ours == capsys.readouterr().out


def profiled_run(tmp, env_cfg, model_cfg, mode: str, capsys) -> tuple:
    """(port phase_timers.json, JAX phase_timers.json, the port's report)
    of one tiny `cli train --profile` run of each package in `mode`,
    same artifact and flags."""
    preset = tiny_preset(tmp / "tiny.json", env_cfg, model_cfg)
    dumps, report = [], None
    for main, app in ((cli.main, PORT_APP), (jcli.main, JAX_APP)):
        root = tmp / app
        argv = [
            "train", "--preset", preset, "--device", "cpu", "--root-dir", str(root),
            "--run-name", mode, "--no-auto-resume", "--no-tensorboard", "--profile",
            "--max-steps", "4", "--self-play-batch", "8", "--batch-size", "8",
            "--min-buffer", "8", "--buffer-capacity", "64", "--rollout-chunk", "2",
            "--checkpoint-freq", "2", "--log-level", "WARNING", *MODES[mode],
        ]
        capsys.readouterr()
        assert main(argv) == 0, (app, mode)
        if app == PORT_APP:
            report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        profile_dir = root / app / "runs" / mode / "profile_data"
        dumps.append(json.loads((profile_dir / "phase_timers.json").read_text()))
        if app == PORT_APP:
            assert len(list(profile_dir.glob("*.pt.trace.json"))) == 1
            assert cli.main(["analyze", str(profile_dir)]) == 0
            assert "phase" in capsys.readouterr().out
    return dumps[0], dumps[1], report


def assert_phases_match(ours: dict, theirs: dict, report: dict, mode: str) -> None:
    """The port's phase counts against JAX's. The overlapped loop's
    counts follow its threads' timing: its names only. The JAX megastep
    loop also installs the learner's weights in its net
    (`weight_sync`), which the port's megastep, whose rollout reads the
    learner's own module, has no need of; and under the 8 virtual
    devices it shards its ring and warms up until every shard holds a
    row, so each run's warm-up chunks come from its own report."""
    counts = {name: s["count"] for name, s in ours.items()}
    want = {name: s["count"] for name, s in theirs.items()}
    assert all(s["total_seconds"] >= 0 for s in ours.values())
    if mode == "async":
        assert set(counts) == set(want)
        assert {"rollout", "fold", "enqueue_wait/stream0", "sample"} <= set(counts)
        return
    if mode == "megastep":
        assert "weight_sync" not in counts
        want.pop("weight_sync", None)
        # Warm-up chunks: the port's ring is ready at MIN_BUFFER rows;
        # the JAX ring, sharded over the 8 virtual devices, once every
        # shard holds a row too.
        assert counts.pop("rollout") == report["warmup_chunks"] >= 1
        assert want.pop("rollout") >= report["warmup_chunks"]
        assert counts["megastep"] == report["megasteps"] == 2
    assert counts == want


def test_cli_train_profile_sync_phases_match_jax(tmp_path, capsys, tiny_env_config, tiny_model_config):
    ours, theirs, report = profiled_run(tmp_path, tiny_env_config, tiny_model_config, "sync", capsys)
    assert_phases_match(ours, theirs, report, "sync")
    assert {"rollout", "sample", "train", "checkpoint"} <= set(ours)
