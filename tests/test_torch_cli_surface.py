"""The port's command line against the JAX package's: every command and
flag, and `cli warm --jobs N` (JAX `cli.py` `warm --jobs`, `warm.py`
`warm_bench_programs(jobs=...)`), whose kernels' `nvcc` builds run in up
to N threads while the plan's programs run one after another.

- Every JAX subcommand is a port subcommand, and each of its options and
  positionals is one of the port's.
- `--jobs` parses, with the JAX default of 4, and a JAX `warm` command
  line (target, `--jobs`, `--programs`) parses unchanged.
- `--jobs 1` and `--jobs 4` give the same rows (program and status) on
  the CPU.
- `ops/_cuda.build_all` runs at most `jobs` builds at once (all at once
  without), each kernel built and loaded once, on stand-in kernels that
  record their builds (no `nvcc` here).
"""

import argparse
import json
import threading
import time

import pytest

pytest.importorskip("torch")

import alphatriangle_tpu.cli as jax_cli  # noqa: E402
from alphatriangle_tpu_torch.cli import build_parser, main  # noqa: E402
from alphatriangle_tpu_torch.ops._cuda import build_all  # noqa: E402
from torch_parity import reset_device_stats  # noqa: E402, F401 (autouse)


class _Parsed(Exception):
    pass


def _flags(parser: argparse.ArgumentParser) -> dict:
    """{subcommand: its option strings and positional names}."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {
        name: {o for a in p._actions for o in a.option_strings}
        | {a.dest for a in p._actions if not a.option_strings}
        for name, p in sub.choices.items()
    }


def test_every_jax_command_and_flag(monkeypatch):
    """The JAX parser (built inside its `main`) is caught at its
    `parse_args`; every command and flag of it is the port's too."""
    seen = []

    def caught(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed

    with monkeypatch.context() as m, pytest.raises(_Parsed):
        m.setattr(argparse.ArgumentParser, "parse_args", caught)
        jax_cli.main(["warm"])
    theirs, mine = _flags(seen[0]), _flags(build_parser())
    assert len(theirs) == 24 and set(theirs) <= set(mine)
    for command, flags in theirs.items():
        assert flags <= mine[command], (command, sorted(flags - mine[command]))


def _jax_args(monkeypatch, argv):
    """The JAX command line's parse of `argv` (its `warm` handler stubbed)."""
    seen = []
    monkeypatch.setattr(jax_cli, "cmd_warm", lambda args: seen.append(args) or 0)
    assert jax_cli.main(argv) == 0
    return seen[0]


def test_jobs_flag_parses_as_the_jax_one(monkeypatch):
    argv = ["warm", "cpu", "--jobs", "3", "--programs", "search,serve"]
    mine, theirs = build_parser().parse_args(argv), _jax_args(monkeypatch, argv)
    assert (mine.target, mine.jobs, mine.programs) == (theirs.target, theirs.jobs, theirs.programs)
    assert mine.jobs == 3
    assert build_parser().parse_args(["warm"]).jobs == _jax_args(monkeypatch, ["warm"]).jobs == 4


def test_jobs_1_and_4_give_the_same_rows(capsys):
    rows = {}
    for jobs in (1, 4):
        rc = main(["warm", "cpu", "--device", "cpu", "--programs", "search", "--jobs", str(jobs)])
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0
        rows[jobs] = [(r["program"], r["status"]) for r in report["programs"]]
    assert rows[1] == rows[4] == [("kernels", "skipped-cpu"), ("search/b64", "ran")]


class _Kernel:
    """Stands in for a `CudaKernel`: a build takes 50 ms and is counted."""

    def __init__(self, name, state):
        self.name, self.state = name, state
        self.loaded = False

    def start_build(self):
        return self.name

    def finish(self, proc):
        with self.state["lock"]:
            self.state["live"] += 1
            self.state["peak"] = max(self.state["peak"], self.state["live"])
        time.sleep(0.05)
        with self.state["lock"]:
            self.state["live"] -= 1
            self.state["built"].append(proc)

    def load(self):
        self.loaded = True


@pytest.mark.parametrize("jobs, peak", [(1, 1), (2, 2), (None, 5)])
def test_build_all_runs_at_most_jobs_builds_at_once(jobs, peak):
    state = {"lock": threading.Lock(), "live": 0, "peak": 0, "built": []}
    kernels = [_Kernel(f"k{i}", state) for i in range(5)]
    build_all(kernels, jobs=jobs)
    assert state["peak"] == peak
    assert sorted(state["built"]) == [k.name for k in kernels] and all(k.loaded for k in kernels)
