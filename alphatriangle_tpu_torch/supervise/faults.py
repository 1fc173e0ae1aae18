"""Fault injection for the chaos drills: counterpart of
`alphatriangle_tpu/supervise/faults.py`, with the same sites, the same
spec grammar and the same once-per-state-dir sentinels.

Armed by environment only, so production paths run untouched:

    ALPHATRIANGLE_FAULTS="hang-dispatch@after=6,sigkill-save@step=4"
    ALPHATRIANGLE_FAULT_STATE_DIR=/tmp/faults   # once-per-run sentinels

Spec: comma-separated `name@key=N` entries. The key names the trigger
counter (`after`: the call ordinal at the site, `step`: the global
training step); a fault fires when its site's counter reaches `N`
(`>=`, so a megastep's K steps cannot skip over it), and at most once
per state dir: the sentinel survives a supervised restart, so the
restarted child runs clean.

The sites and their faults (every hook is an env-gated lazy import, so
an unarmed process never loads this module):

    hang-dispatch@after=N   telemetry.flight.FlightRecorder.begin —
                            block the dispatching thread past its
                            deadline, after the intent is durable and
                            the watchdog armed; dies by the real
                            `os._exit(113)`
    corrupt-ring@after=N    same site — append a torn record to
                            flight.jsonl (the tolerant readers' drill)
    sigterm@step=N          training.loop.TrainingLoop._record_step —
                            SIGTERM to self (the preemption drill)
    sigkill@step=N          same site — SIGKILL, no cleanup at all
    crash@step=N            same site — raise RuntimeError
    sigkill-save@step=N     stats.persistence.CheckpointManager.save,
                            after the state and the meta are written
                            and before the commit marker — the
                            torn-checkpoint drill
    hang-serve@after=N      serving.PolicyService.dispatch — block the
                            serve dispatch inside its flight bracket
                            (unsealed `serve/b<B>` intent; the replica's
                            watchdog exits 113, the fleet re-routes)
    crash-serve@after=N     same site — raise RuntimeError inside the
                            bracket (seals ok:false, the replica survives)

Stdlib only: the supervisor parent and the telemetry import it.
"""

import logging
import os
import signal
import time
from pathlib import Path

logger = logging.getLogger(__name__)

FAULTS_ENV = "ALPHATRIANGLE_FAULTS"
FAULT_STATE_DIR_ENV = "ALPHATRIANGLE_FAULT_STATE_DIR"

#: site -> fault names it can fire (anything else in the spec is
#: ignored at that site).
SITE_FAULTS = {
    "dispatch": ("hang-dispatch", "corrupt-ring"),
    "step": ("sigterm", "sigkill", "crash"),
    "checkpoint-save": ("sigkill-save",),
    "serve-dispatch": ("hang-serve", "crash-serve"),
}

# A hung dispatch must die by watchdog, not hang forever if the
# watchdog is misconfigured/off; past the cap the fault aborts loudly.
_HANG_CAP_S = 180.0

_parse_cache: "tuple[str, dict[str, int]] | None" = None
_fired_in_process: set[str] = set()


def parse_spec(spec: str) -> dict[str, int]:
    """`"hang-dispatch@after=6,sigterm@step=3"` -> {name: threshold}.
    Malformed entries are skipped with a warning, never raised — a typo
    in a chaos env var must not change the run's control flow."""
    out: dict[str, int] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        try:
            name, cond = entry.split("@", 1)
            _key, value = cond.split("=", 1)
            out[name.strip()] = int(value)
        except ValueError:
            logger.warning("Unparseable fault spec entry %r; ignoring", entry)
    return out


def _armed_faults() -> dict[str, int]:
    global _parse_cache
    spec = os.environ.get(FAULTS_ENV, "")
    if _parse_cache is None or _parse_cache[0] != spec:
        _parse_cache = (spec, parse_spec(spec))
    return _parse_cache[1]


def _claim(name: str) -> bool:
    """Atomically claim the once-per-run sentinel for `name`. With no
    state dir the claim is once-per-process only."""
    state_dir = os.environ.get(FAULT_STATE_DIR_ENV)
    if not state_dir:
        if name in _fired_in_process:
            return False
        _fired_in_process.add(name)
        return True
    path = Path(state_dir) / f"{name}.fired"
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
        return True
    except FileExistsError:
        return False
    except OSError:
        logger.exception("fault sentinel claim failed for %s", name)
        return False


def fault_point(site: str, n: int, flight_path: "Path | str | None" = None) -> None:
    """Evaluate the armed faults for `site` at counter value `n` and
    fire any whose threshold is reached (once per state dir each)."""
    armed = _armed_faults()
    if not armed:
        return
    for name in SITE_FAULTS.get(site, ()):
        threshold = armed.get(name)
        if threshold is None or n < threshold or not _claim(name):
            continue
        logger.error("FAULT %s firing at %s=%d", name, site, n)
        if name in ("hang-dispatch", "hang-serve"):
            _hang()
        elif name == "crash-serve":
            raise RuntimeError(f"injected serve-dispatch crash at dispatch {n}")
        elif name == "corrupt-ring":
            _corrupt_ring(flight_path)
        elif name == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
        elif name in ("sigkill", "sigkill-save"):
            os.kill(os.getpid(), signal.SIGKILL)
        elif name == "crash":
            raise RuntimeError(f"injected crash fault at step {n}")


def _hang() -> None:
    """Block this thread like a wedged device program: the armed
    DispatchWatchdog is expected to fire `os._exit(113)` mid-sleep."""
    deadline = time.monotonic() + _HANG_CAP_S
    while time.monotonic() < deadline:
        time.sleep(0.05)
    raise RuntimeError(
        "hang fault outlived its cap without the dispatch watchdog firing — is the watchdog "
        "disabled?"
    )


def _corrupt_ring(flight_path: "Path | str | None") -> None:
    """Append a torn (newline-less, truncated-JSON) record to the flight
    ring, as a kill mid-append leaves it; the tolerant readers must skip
    it without losing the rest of the ring."""
    if flight_path is None:
        return
    try:
        with open(flight_path, "ab") as f:
            f.write(b'{"kind": "flight", "phase": "inte')
    except OSError:
        logger.exception("corrupt-ring fault could not write %s", flight_path)
