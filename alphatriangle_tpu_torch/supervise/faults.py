"""Fault injection for the chaos drills: counterpart of
`alphatriangle_tpu/supervise/faults.py`, with the same spec grammar and
the same once-per-state-dir sentinels.

Armed by environment only, so production paths run untouched:

    ALPHATRIANGLE_FAULTS="hang-serve@after=6,crash-serve@after=3"
    ALPHATRIANGLE_FAULT_STATE_DIR=/tmp/faults   # once-per-run sentinels

Spec: comma-separated `name@key=N` entries; a fault fires when its site's
counter reaches `N` (`>=`, so a skipped count cannot dodge it), and at
most once per state dir: the sentinel survives a respawn, so the
respawned process runs clean.

The one site and its faults (the hook is an env-gated lazy import, so
an unarmed process never loads this module):

    hang-serve@after=N      serving.PolicyService.dispatch — block the
                            serve dispatch inside its flight bracket
                            (unsealed `serve/b<B>` intent; the replica's
                            watchdog exits 113, the fleet re-routes)
    crash-serve@after=N     same site — raise RuntimeError inside the
                            bracket (seals ok:false, the replica survives)

The JAX package's training and flight-ring sites wait for the slices
that arm them. Stdlib only.
"""

import logging
import os
import time
from pathlib import Path

logger = logging.getLogger(__name__)

FAULTS_ENV = "ALPHATRIANGLE_FAULTS"
FAULT_STATE_DIR_ENV = "ALPHATRIANGLE_FAULT_STATE_DIR"

#: site -> fault names it can fire (anything else in the spec is
#: ignored at that site).
SITE_FAULTS = {
    "serve-dispatch": ("hang-serve", "crash-serve"),
}

# A hung dispatch must die by watchdog, not hang forever if the
# watchdog is misconfigured/off; past the cap the fault aborts loudly.
_HANG_CAP_S = 180.0

_parse_cache: "tuple[str, dict[str, int]] | None" = None
_fired_in_process: set[str] = set()


def parse_spec(spec: str) -> dict[str, int]:
    """`"hang-serve@after=6,crash-serve@after=3"` -> {name: threshold}.
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


def fault_point(site: str, n: int) -> None:
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
        if name == "hang-serve":
            _hang()
        elif name == "crash-serve":
            raise RuntimeError(
                f"injected serve-dispatch crash at dispatch {n}"
            )


def _hang() -> None:
    """Block this thread like a wedged device program: the armed
    DispatchWatchdog is expected to fire `os._exit(113)` mid-sleep."""
    deadline = time.monotonic() + _HANG_CAP_S
    while time.monotonic() < deadline:
        time.sleep(0.05)
    raise RuntimeError(
        "hang-serve fault outlived its cap without the dispatch "
        "watchdog firing — is the watchdog disabled?"
    )

