"""The port's supervisor against the JAX package's (both stdlib):

- `_apply_supervise_overrides` gives JAX's `TrainConfig` fields for the
  same environment: replacements, the quarantines, `<FIELD>__scale`
  (rounded, at least 1), `TELEMETRY__BEACONS` (popped, and the beacons
  armed in both packages), unparseable and empty values.
- `Supervisor` against JAX's `Supervisor` under the same scripted child
  and frozen clock: a wedge, a second wedge that quarantines the megastep
  family, then completion (0); deaths without progress until the circuit
  breaker gives up (115); a SIGTERM forwarded to the child (its 114).
  Both write the same `supervisor.jsonl` events (up to times, pids and
  trace ids), spawn the same argv with the same override environment,
  sleep the same backoffs and move the same reports aside.
- `latest_committed_step` equals JAX's on the same checkpoint layouts.
- `cli supervise` pins `--run-name` / `--root-dir` / `--no-auto-resume`
  on the child as JAX's does, and builds the same policy.
"""

import json
import signal
from pathlib import Path

import pytest

from alphatriangle_tpu import cli as jcli
from alphatriangle_tpu import supervise as jsupervise
from alphatriangle_tpu.config import TrainConfig as JaxTrainConfig
from alphatriangle_tpu.supervise import RecoveryPolicy as JaxPolicy
from alphatriangle_tpu.supervise import supervisor as jsup
from alphatriangle_tpu.telemetry import device_stats as jds
from alphatriangle_tpu.training import runner as jrunner
from alphatriangle_tpu_torch import cli
from alphatriangle_tpu_torch import supervise as tsupervise
from alphatriangle_tpu_torch.config import TrainConfig
from alphatriangle_tpu_torch.supervise import RecoveryPolicy
from alphatriangle_tpu_torch.supervise import supervisor as tsup
from alphatriangle_tpu_torch.telemetry import device_stats as tds
from alphatriangle_tpu_torch.telemetry import tracectx
from alphatriangle_tpu_torch.training import runner
from torch_parity import plain_jax_programs  # noqa: F401 (autouse)

OVERRIDES = [
    None, "not json", "[1, 2]", {},
    {"FUSED_MEGASTEP": False},
    {"FUSED_LEARNER_STEPS": 1},
    {"ASYNC_ROLLOUTS": False},
    {"SELF_PLAY_BATCH_SIZE__scale": 0.5},
    {"SELF_PLAY_BATCH_SIZE__scale": 0.25, "FUSED_LEARNER_STEPS": 1},
    {"SELF_PLAY_BATCH_SIZE__scale": 0.001},
    {"TELEMETRY__BEACONS": True},
    {"TELEMETRY__BEACONS": True, "FUSED_MEGASTEP": False},
    {"TELEMETRY__BEACONS": False, "SELF_PLAY_BATCH_SIZE__scale": 0.5},
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: json.dumps(o) if o is not None else "unset")
def test_supervise_overrides_match_jax(monkeypatch, overrides):
    if overrides is None:
        monkeypatch.delenv(runner.SUPERVISE_OVERRIDES_ENV, raising=False)
    else:
        raw = overrides if isinstance(overrides, str) else json.dumps(overrides)
        monkeypatch.setenv(runner.SUPERVISE_OVERRIDES_ENV, raw)
    assert runner.SUPERVISE_OVERRIDES_ENV == jrunner.SUPERVISE_OVERRIDES_ENV == tsup.OVERRIDES_ENV
    base = dict(RUN_NAME="r", SELF_PLAY_BATCH_SIZE=24, FUSED_MEGASTEP=True, FUSED_LEARNER_STEPS=4,
                MAX_TRAINING_STEPS=100)
    ours = runner._apply_supervise_overrides(TrainConfig(**base)).model_dump()
    theirs = jrunner._apply_supervise_overrides(JaxTrainConfig(**base)).model_dump()
    common = set(ours) & set(theirs)
    assert len(common) > 40
    assert {k: ours[k] for k in common} == {k: theirs[k] for k in common}
    want_armed = isinstance(overrides, dict) and bool(overrides.get("TELEMETRY__BEACONS"))
    assert tds.beacons_armed() == jds.beacons_armed() == want_armed
    if isinstance(overrides, dict) and "SELF_PLAY_BATCH_SIZE__scale" in overrides:
        assert ours["SELF_PLAY_BATCH_SIZE"] == max(1, round(24 * overrides["SELF_PLAY_BATCH_SIZE__scale"]))
    if isinstance(overrides, dict) and overrides.get("FUSED_MEGASTEP") is False:
        assert ours["FUSED_MEGASTEP"] is False  # the quarantine turns the child synchronous


class Clock:
    """A frozen clock that moves one second a reading and by each sleep."""

    def __init__(self) -> None:
        self.t = 1_000.0
        self.slept: list = []

    def now(self) -> float:
        self.t += 1.0
        return self.t

    def sleep(self, s: float) -> None:
        self.slept.append(s)
        self.t += s


def _wedge(step: int):
    """A child that wedged in its second megastep after committing `step`."""
    def write(run: Path, t: float) -> int:
        ckpt = run / "checkpoints"
        (ckpt / f"step_{step:08d}").mkdir(parents=True, exist_ok=True)
        (ckpt / f"step_{step:08d}.meta.json").write_text(json.dumps({"global_step": step}))
        (ckpt / f"step_{step:08d}.commit").write_text("{}")
        rec = {"kind": "flight", "program": "megastep/t2_k2", "family": "megastep", "pid": 7}
        with open(run / "flight.jsonl", "a") as f:
            f.write(json.dumps({**rec, "phase": "intent", "seq": 1, "time": t, "t_mono": 1.0}) + "\n")
            f.write(json.dumps({**rec, "phase": "seal", "seq": 1, "wall_s": 1.1, "time": t, "t_mono": 2.0}) + "\n")
            f.write(json.dumps({**rec, "phase": "intent", "seq": 2, "time": t, "t_mono": 3.0}) + "\n")
        (run / "wedge_report.json").write_text(json.dumps({
            "kind": "wedge", "time": t, "pid": 7, "program": "megastep/t2_k2", "family": "megastep",
            "seq": 2, "deadline_s": 15.0, "elapsed_s": 15.5, "exit_code": 113,
        }))
        return 113
    return write


def _crash(run: Path, t: float) -> int:
    return 1


def _complete(run: Path, t: float) -> int:
    return 0


class ScriptedChild:
    def __init__(self, step, clock: Clock, run: Path, holder: dict) -> None:
        self.step, self.clock, self.run, self.holder = step, clock, run, holder
        self.rc = None
        self.signals: list = []

    def wait(self) -> int:
        if self.step == "signal":
            self.holder["sup"]._forward_signal(signal.SIGTERM, None)
            self.rc = 114
        else:
            self.rc = self.step(self.run, self.clock.t + 0.5)
        return self.rc

    def poll(self):
        return self.rc

    def send_signal(self, sig) -> None:
        self.signals.append(int(sig))


def _supervise(mod, policy_cls, run: Path, script: list, **policy_kw) -> dict:
    clock = Clock()
    calls, children, holder = [], [], {}

    def popen(argv, env=None):
        calls.append((list(argv), dict(env or {})))
        children.append(ScriptedChild(script.pop(0), clock, run, holder))
        return children[-1]

    policy = policy_cls(backoff_base_s=1.0, clock=lambda: 0.0, **policy_kw)
    sup = holder["sup"] = mod.Supervisor(["python", "-m", "child", "train"], run, policy=policy,
                                          popen=popen, sleep=clock.sleep, now=clock.now)
    rc = sup.run()
    events = []
    for line in (run / "supervisor.jsonl").read_text().splitlines():
        e = json.loads(line)
        for volatile in ("time", "pid", "trace_id", "span_id", "parent_id"):
            e.pop(volatile, None)
        events.append(e)
    return {
        "rc": rc, "events": events, "argv": [a for a, _ in calls],
        "overrides": [json.loads(env[mod.OVERRIDES_ENV]) if mod.OVERRIDES_ENV in env else None
                      for _, env in calls],
        "traceparent": [tracectx.TRACEPARENT_ENV in env for _, env in calls],
        "slept": clock.slept, "signals": [c.signals for c in children],
        "archived": sorted(p.name for p in run.glob("*.attempt*")),
    }


@pytest.mark.parametrize(
    "name,script,policy_kw,want_rc",
    [
        ("wedge-quarantine-complete", lambda: [_wedge(4), _wedge(6), _complete], {}, 0),
        ("give-up", lambda: [_crash] * 6, {"circuit_breaker_deaths": 3}, 115),
        ("budget", lambda: [_wedge(2), _wedge(4), _wedge(6), _complete], {"max_restarts": 2}, 115),
        ("forwarded-signal", lambda: ["signal"], {}, 114),
    ],
)
def test_supervisor_matches_jax(tmp_path, name, script, policy_kw, want_rc):
    ours = _supervise(tsup, RecoveryPolicy, tmp_path / "port", script(), **policy_kw)
    theirs = _supervise(jsup, JaxPolicy, tmp_path / "jax", script(), **policy_kw)
    assert ours == theirs
    assert ours["rc"] == want_rc
    assert all(ours["traceparent"])
    kinds = [e["event"] for e in ours["events"]]
    if name == "wedge-quarantine-complete":
        assert kinds == ["spawn", "death", "spawn", "death", "spawn", "complete"]
        first, second = ours["events"][1], ours["events"][3]
        assert (first["rc"], first["verdict"], first["family"], first["progress_step"]) == (
            113, "dispatch-hung", "megastep", 4)
        assert ours["overrides"] == [None, {"TELEMETRY__BEACONS": True},
                                     {"TELEMETRY__BEACONS": True, "FUSED_MEGASTEP": False}]
        assert second["progress_step"] == 6 and "quarantined family 'megastep'" in second["reason"]
        assert ours["archived"] == ["wedge_report.json.attempt1", "wedge_report.json.attempt2"]
    elif name == "give-up":
        assert kinds[-1] == "give-up" and kinds.count("death") == 4
    elif name == "forwarded-signal":
        assert kinds == ["spawn", "forward-signal", "terminated"]
        assert ours["events"][1]["signum"] == int(signal.SIGTERM)
    assert set(ours["events"][0]) >= {"kind", "event", "attempt", "argv", "overrides"}


def _layout(root: Path, name: str) -> Path:
    run = root / name
    ckpt = run / "checkpoints"
    if name == "none":
        run.mkdir(parents=True)
        return run
    ckpt.mkdir(parents=True)

    def step(n, commit=False, meta="{}"):
        (ckpt / f"step_{n:08d}").mkdir()
        if meta is not None:
            (ckpt / f"step_{n:08d}.meta.json").write_text(meta)
        if commit:
            (ckpt / f"step_{n:08d}.commit").write_text("{}")

    if name == "committed":
        step(2, commit=True), step(4, commit=True), step(6)  # step 6 torn
    elif name == "legacy":
        step(2), step(6), step(8, meta="{torn"), step(10, meta=None)
        (ckpt / "step_latest").mkdir()
    elif name == "empty":
        (ckpt / "notes.txt").write_text("x")
    return run


@pytest.mark.parametrize("name", ["none", "committed", "legacy", "empty"])
def test_latest_committed_step_matches_jax(tmp_path, name):
    run = _layout(tmp_path, name)
    got = tsup.latest_committed_step(run)
    assert got == jsup.latest_committed_step(run)
    assert got == {"none": None, "committed": 4, "legacy": 6, "empty": None}[name]


@pytest.mark.parametrize(
    "child",
    [
        ["--", "train", "--max-steps", "3"],
        [],
        ["--", "league", "--pool-from", "p"],
        ["--", "train", "--run-name", "y", "--no-auto-resume", "--root-dir", "elsewhere"],
        ["--", "eval", "--games", "2"],
    ],
)
def test_cli_supervise_pins_the_child_as_jax(monkeypatch, tmp_path, child):
    seen = {}

    def recorder(key):
        class Recorder:
            def __init__(self, argv, run_dir, policy=None):
                seen[key] = (argv, Path(run_dir), policy)

            def run(self):
                return 0
        return Recorder

    monkeypatch.setattr(tsupervise, "Supervisor", recorder("port"))
    monkeypatch.setattr(jsupervise, "Supervisor", recorder("jax"))
    argv = ["supervise", "--run-name", "x", "--root-dir", str(tmp_path), "--max-restarts", "3",
            "--backoff-base", "0.5", "--quarantine-after", "1", *child]
    assert cli.main(argv) == jcli.main(argv) == 0
    (ours, our_dir, our_policy), (theirs, their_dir, their_policy) = seen["port"], seen["jax"]
    assert ours[1:3] == ["-m", "alphatriangle_tpu_torch.cli"] and theirs[1:3] == ["-m", "alphatriangle_tpu.cli"]
    assert ours[3:] == theirs[3:]
    assert our_dir.relative_to(tmp_path).parts[1:] == their_dir.relative_to(tmp_path).parts[1:] == ("runs", "x")
    for attr in ("max_restarts", "circuit_breaker_deaths", "backoff_base_s", "backoff_max_s", "quarantine_after"):
        assert getattr(our_policy, attr) == getattr(their_policy, attr)
