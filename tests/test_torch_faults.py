"""The port's fault injection against the JAX package's (both stdlib):

- `SITE_FAULTS` and `parse_spec` equal JAX's, malformed entries too.
- `fault_point` fires each fault at the same counter value as JAX's on
  the same spec, at most once per state dir (a second process with the
  same dir runs clean), once per process without one.
- The three sites a training run arms fire at the same ordinal as JAX's:
  `dispatch` in `FlightRecorder.begin` (hang-dispatch after the intent
  is written, corrupt-ring's torn record skipped by both readers alike),
  `step` in `TrainingLoop._record_step` (sigterm, sigkill, crash) and
  `checkpoint-save` in `CheckpointManager.save` (sigkill-save between
  the meta and the commit marker: a torn, uncommitted step that both
  packages' `latest_committed_step` and restore skip).
- `cli train` exits 113 by the dispatch watchdog under `hang-dispatch`
  in the synchronous and the overlapped loop, leaving a wedge report
  naming the hung program (the megastep loop's: `test_torch_chaos.py`).
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import pytest
import torch

from alphatriangle_tpu.config import PersistenceConfig as JaxPersistence
from alphatriangle_tpu.stats.persistence import CheckpointManager as JaxManager
from alphatriangle_tpu.supervise import faults as jfaults
from alphatriangle_tpu.supervise.supervisor import latest_committed_step as jax_latest
from alphatriangle_tpu.telemetry import flight as jflight
from alphatriangle_tpu.training.loop import TrainingLoop as JaxLoop
from alphatriangle_tpu_torch.config import PersistenceConfig
from alphatriangle_tpu_torch.stats.persistence import CheckpointManager
from alphatriangle_tpu_torch.supervise import faults
from alphatriangle_tpu_torch.supervise.supervisor import latest_committed_step
from alphatriangle_tpu_torch.telemetry import flight
from alphatriangle_tpu_torch.training.loop import TrainingLoop
from torch_parity import plain_jax_programs  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"port": faults, "jax": jfaults}


class Fired(Exception):
    """What a fault does in these tests instead of hanging or killing."""


@pytest.fixture
def tame(monkeypatch):
    """Faults that raise instead of acting: a hang and a signal to self
    raise `Fired(name)`; a crash raises as it does."""

    def kill(pid, sig):
        assert pid == os.getpid()
        raise Fired(signal.Signals(sig).name)

    def hang():
        raise Fired("hang")

    monkeypatch.setattr(os, "kill", kill)
    for mod in PACKAGES.values():
        monkeypatch.setattr(mod, "_hang", hang)
        monkeypatch.setattr(mod, "_fired_in_process", set())


def _arm(monkeypatch, spec: str, state_dir) -> None:
    monkeypatch.setenv("ALPHATRIANGLE_FAULTS", spec)
    if state_dir is None:
        monkeypatch.delenv("ALPHATRIANGLE_FAULT_STATE_DIR", raising=False)
    else:
        monkeypatch.setenv("ALPHATRIANGLE_FAULT_STATE_DIR", str(state_dir))


def test_sites_and_spec_grammar_match_jax():
    assert faults.SITE_FAULTS == jfaults.SITE_FAULTS
    assert (faults.FAULTS_ENV, faults.FAULT_STATE_DIR_ENV) == (jfaults.FAULTS_ENV, jfaults.FAULT_STATE_DIR_ENV)
    for spec in (
        "", "hang-dispatch@after=6", "hang-dispatch@after=6,sigterm@step=3", " crash@step=2 , ,",
        "sigkill-save@step=4,corrupt-ring@after=1", "nonsense", "x@y", "a@b=c,d@e=5", "hang-serve@after=0",
    ):
        assert faults.parse_spec(spec) == jfaults.parse_spec(spec), spec


def _fire_ordinals(mod, site: str, upto: int) -> list:
    """The counter values at which `site` fired, calling 1..upto."""
    out = []
    for n in range(1, upto + 1):
        try:
            mod.fault_point(site, n)
        except (Fired, RuntimeError) as exc:
            out.append((n, type(exc).__name__, str(exc) if isinstance(exc, Fired) else "crash"))
    return out


@pytest.mark.parametrize(
    "site,spec",
    [
        ("dispatch", "hang-dispatch@after=3"),
        ("step", "sigterm@step=2"),
        ("step", "sigkill@step=5"),
        ("step", "crash@step=1,sigterm@step=4"),
        ("checkpoint-save", "sigkill-save@step=4"),
        ("serve-dispatch", "crash-serve@after=2,hang-serve@after=3"),
        ("dispatch", "sigkill@step=1"),  # not this site's fault: never fires
    ],
)
def test_fault_point_fires_at_the_jax_ordinal(tame, monkeypatch, tmp_path, site, spec):
    got = {}
    for name, mod in PACKAGES.items():
        _arm(monkeypatch, spec, tmp_path / name)
        got[name] = _fire_ordinals(mod, site, 8)
        # The sentinels survive a respawn: a second pass runs clean.
        assert _fire_ordinals(mod, site, 8) == []
    assert got["port"] == got["jax"]
    assert sorted(p.name for p in (tmp_path / "port").glob("*.fired")) == sorted(
        p.name for p in (tmp_path / "jax").glob("*.fired")
    )
    assert bool(got["port"]) == (site != "dispatch" or "hang" in spec)


def test_without_a_state_dir_a_fault_fires_once_a_process(tame, monkeypatch):
    for mod in PACKAGES.values():
        _arm(monkeypatch, "crash@step=2", None)
        assert _fire_ordinals(mod, "step", 4) == [(2, "RuntimeError", "crash")]
        assert _fire_ordinals(mod, "step", 4) == []


def _ring(path) -> list:
    return [(r["phase"], r["seq"], r["program"]) for r in flight.read_flight(path)]


def test_dispatch_site_matches_jax(tame, monkeypatch, tmp_path):
    """hang-dispatch fires in `begin` once the intent is written (the
    ring ends on an unsealed intent); corrupt-ring's torn record is
    skipped by both packages' readers alike."""
    rings = {}
    for name, mod in (("port", flight), ("jax", jflight)):
        _arm(monkeypatch, "corrupt-ring@after=2,hang-dispatch@after=4", tmp_path / f"{name}-faults")
        rec = mod.FlightRecorder(tmp_path / name / "flight.jsonl")
        hung = None
        for i in range(1, 7):
            try:
                span = rec.begin("rollout", f"self_play_chunk/t{i % 2 + 1}")
            except Fired:
                hung = i
                break
            span.seal()
        assert hung == 4
        rings[name] = tmp_path / name / "flight.jsonl"
    assert _ring(rings["port"]) == _ring(rings["jax"])
    assert [r[:2] for r in _ring(rings["port"])][-1] == ("intent", 4)
    for reader in (flight.read_flight, jflight.read_flight):
        assert [r["seq"] for r in reader(rings["port"]) if r["phase"] == "intent"] == [1, 2, 3, 4]
    assert flight.unsealed_intents(flight.read_flight(rings["port"]))[-1]["seq"] == 4


def _fake_loop(use_per: bool = False):
    events = []
    return SimpleNamespace(
        c=SimpleNamespace(buffer=SimpleNamespace(beta=lambda step: 0.4),
                          stats=SimpleNamespace(log_batch_events=events.extend)),
        cfg=SimpleNamespace(USE_PER=use_per),
        telemetry=SimpleNamespace(on_learner_step=lambda step, values: []),
        metrics=[], global_step=0, _steps_this_run=0, events=events,
    )


@pytest.mark.parametrize("spec", ["sigterm@step=3", "sigkill@step=2", "crash@step=4", "crash@step=0"])
def test_step_site_matches_jax(tame, monkeypatch, tmp_path, spec):
    metrics = {"total_loss": 1.0, "policy_loss": 0.5, "value_loss": 0.5, "entropy": 2.0,
               "grad_norm": 0.1, "learning_rate": 1e-3}
    stopped = {}
    for name, record in (("port", TrainingLoop._record_step), ("jax", JaxLoop._record_step)):
        _arm(monkeypatch, spec, tmp_path / name)
        loop = _fake_loop()
        stopped[name] = None
        for step in range(1, 7):
            try:
                record(loop, metrics, None, None, step)
            except (Fired, RuntimeError) as exc:
                # The step's bookkeeping is done before the fault fires.
                stopped[name] = (step, loop.global_step, loop._steps_this_run, str(exc)[:30])
                break
    assert stopped["port"] == stopped["jax"] is not None


def test_checkpoint_save_site_matches_jax(tame, monkeypatch, tmp_path):
    """sigkill-save fires between the meta and the commit marker, at the
    first save at or past its step, in both packages: the step directory
    and its meta are on disk, its marker is not, and every reader trusts
    the step before it."""
    port = CheckpointManager(PersistenceConfig(ROOT_DATA_DIR=str(tmp_path / "p"), RUN_NAME="r"))
    jmgr = JaxManager(JaxPersistence(ROOT_DATA_DIR=str(tmp_path / "j"), RUN_NAME="r"))
    killed = {}
    for name, mgr, state in (
        ("port", port, {"w": torch.arange(3.0)}),
        ("jax", jmgr, {"w": jnp.arange(3.0)}),
    ):
        _arm(monkeypatch, "sigkill-save@step=3", tmp_path / f"{name}-faults")
        for step in (2, 4, 6):
            try:
                mgr.save(step, state, counters={"episodes_played": step})
            except Fired as exc:
                killed[name] = (step, str(exc))
                break
        if name == "jax":
            mgr._ckptr.wait_until_finished()
    assert killed["port"] == killed["jax"] == (4, "SIGKILL")
    for mgr, app in ((port, "AlphaTriangleTPUTorch"), (jmgr, "AlphaTriangleTPU")):
        ckpt = tmp_path / ("p" if mgr is port else "j") / app / "runs" / "r" / "checkpoints"
        names = sorted(p.name for p in ckpt.iterdir())
        assert {"step_00000004", "step_00000004.meta.json", "step_00000002.commit"} <= set(names)
        assert "step_00000004.commit" not in names
        assert latest_committed_step(ckpt.parent) == jax_latest(ckpt.parent) == 2
    assert (tmp_path / "p" / "AlphaTriangleTPUTorch" / "runs" / "r" / "checkpoints" / "step_00000004"
            / "train_state.pt").is_file()
    assert port.valid_steps() == [2]


# Each mode's hang lands on a dispatch of a program that has sealed
# before (a learner step; a producer's one-move chunk), so its deadline is
# max(5 s, 10 x a short expected wall), not the first dispatch's 900 s.
# The child runs on one CPU thread: several multi-threaded children on a
# busy machine slowed a first chunk past 120 s, and every later deadline
# with it.
@pytest.mark.parametrize("mode,after", [("sync", 4), ("async", 7)])
def test_cli_train_wedges_with_113_in_every_loop_mode(tmp_path, mode, after):
    """The dispatch watchdog's `os._exit(113)` under an injected hang in
    the synchronous and the overlapped loop (the megastep loop's is the
    supervised drill of `test_torch_chaos.py`): a wedge report naming the
    hung program, whose intent the ring leaves unsealed."""
    flags = {"sync": ["--rollout-chunk", "4"], "async": ["--async-rollouts", "--workers", "2",
                                                         "--rollout-chunk", "1"]}[mode]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "ALPHATRIANGLE_FAULTS": f"hang-dispatch@after={after}",
           "ALPHATRIANGLE_FAULT_STATE_DIR": str(tmp_path / "faults"), "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-m", "alphatriangle_tpu_torch.cli", "train", "--device", "cpu", *flags,
         "--max-steps", "6", "--self-play-batch", "2", "--batch-size", "4", "--min-buffer", "4",
         "--buffer-capacity", "64", "--root-dir", str(tmp_path / "runs"),
         "--run-name", "w", "--no-auto-resume", "--no-tensorboard", "--dispatch-min-deadline", "5",
         "--dispatch-watchdog-poll", "0.1", "--log-level", "WARNING"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 113, proc.stderr[-3000:]
    run = tmp_path / "runs" / "AlphaTriangleTPUTorch" / "runs" / "w"
    report = json.loads((run / "wedge_report.json").read_text())
    torn = flight.unsealed_intents(flight.read_flight(run / "flight.jsonl"))
    hung = [t for t in torn if t["seq"] == after]
    assert report["exit_code"] == 113 and report["seq"] == after and len(hung) == 1
    assert report["program"] == hung[0]["program"]
    assert (tmp_path / "faults" / "hang-dispatch.fired").exists()
