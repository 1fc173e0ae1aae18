"""Postmortem diagnosis of a run directory: counterpart of
`alphatriangle_tpu/supervise/supervisor.py`'s `diagnose`.

The fleet supervisor (serving/fleet.py) classifies each replica death
with it over the replica's own run directory, the evidence restricted to
the current incarnation. The `Supervisor` class and `cli supervise` are
not ported yet. Stdlib only.
"""

import json
from pathlib import Path

from ..telemetry.flight import (
    FLIGHT_FILENAME,
    PREEMPT_REPORT_FILENAME,
    WEDGE_REPORT_FILENAME,
    classify_run,
    read_flight,
    read_preempt_report,
    read_wedge_report,
)
from ..telemetry.ledger import read_ledger, resolve_ledger_path


def diagnose(run_dir: Path | str, since: float = 0.0) -> dict:
    """`cli doctor`'s classification over the run dir's evidence,
    restricted to records from the current attempt (`since`, an epoch
    time): a prior attempt's torn intent or stale heartbeat must not
    pollute the verdict for THIS death."""
    run_dir = Path(run_dir)
    flight = [
        r
        for r in read_flight(run_dir / FLIGHT_FILENAME)
        if float(r.get("time") or 0.0) >= since
    ]
    health = None
    try:
        payload = json.loads((run_dir / "health.json").read_text())
        if (
            isinstance(payload, dict)
            and float(payload.get("time") or 0.0) >= since
        ):
            health = payload
    except (OSError, ValueError):
        pass
    ledger = resolve_ledger_path(run_dir)
    utils = [
        r
        for r in (read_ledger(ledger, kinds={"util"}) if ledger else [])
        if float(r.get("time") or 0.0) >= since
    ]
    wedge = read_wedge_report(run_dir / WEDGE_REPORT_FILENAME)
    if wedge is not None and float(wedge.get("time") or 0.0) < since:
        wedge = None
    preempt = read_preempt_report(run_dir / PREEMPT_REPORT_FILENAME)
    if preempt is not None and float(preempt.get("time") or 0.0) < since:
        preempt = None
    return classify_run(
        flight, health=health, utils=utils, wedge=wedge, preempt=preempt
    )
