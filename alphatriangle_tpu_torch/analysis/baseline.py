"""graftlint baseline of the port: grandfathered findings, with rot
protection (counterpart of `alphatriangle_tpu/analysis/baseline.py`).

The baseline file is a checked-in JSON list of finding keys (see
`Finding.key`: rule + path + enclosing scope + offending-line text
hash, deliberately line-number-free so pure line drift never stales
an entry). A finding matching an entry is suppressed; an entry that no
longer matches ANY finding is STALE and fails the lint (exit 1) — a
suppression must be deleted the moment its hazard is gone, or the file
becomes a place findings go to be forgotten. The port keeps its own
file (`alphatriangle_tpu_torch/lint_baseline.json`): the repository
root's `lint_baseline.json` holds the JAX package's keys.
"""

from __future__ import annotations

import json
from pathlib import Path

from .model import Finding

BASELINE_SCHEMA = "alphatriangle.lint-baseline.v1"


def load_baseline(path: Path | str | None) -> list[dict]:
    """Entries from a baseline file; [] when absent. Raises ValueError
    on an unreadable/mis-schema'd file — a corrupt baseline silently
    treated as empty would resurface every grandfathered finding."""
    if path is None:
        return []
    p = Path(path)
    if not p.exists():
        return []
    try:
        data = json.loads(p.read_text())
    except json.JSONDecodeError as e:
        raise ValueError(f"baseline {p} is not valid JSON: {e}") from e
    if not isinstance(data, dict) or data.get("schema") != BASELINE_SCHEMA:
        raise ValueError(
            f"baseline {p} missing schema '{BASELINE_SCHEMA}' header"
        )
    entries = data.get("entries", [])
    if not isinstance(entries, list):
        raise ValueError(f"baseline {p}: 'entries' must be a list")
    return entries


def apply_baseline(
    findings: list[Finding], entries: list[dict]
) -> tuple[list[Finding], list[Finding], list[dict]]:
    """(kept, suppressed, stale_entries).

    An entry suppresses every finding whose key matches it (a key can
    legitimately match twice — e.g. the same fetch pattern repeated in
    one function body produces identical line text)."""
    keys = {str(e.get("key")) for e in entries}
    kept = [f for f in findings if f.key not in keys]
    suppressed = [f for f in findings if f.key in keys]
    live = {f.key for f in suppressed}
    stale = [e for e in entries if str(e.get("key")) not in live]
    return kept, suppressed, stale


def write_baseline(path: Path | str, findings: list[Finding]) -> None:
    """Grandfather the given findings (sorted, deduped by key)."""
    seen: set[str] = set()
    entries = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        if f.key in seen:
            continue
        seen.add(f.key)
        entries.append(
            {
                "key": f.key,
                "rule": f.rule,
                "path": f.path,
                "context": f.context,
                # Advisory only (matching is by key): where it was when
                # grandfathered, so humans can find it.
                "line": f.line,
                "message": f.message,
            }
        )
    Path(path).write_text(
        json.dumps(
            {"schema": BASELINE_SCHEMA, "entries": entries}, indent=2
        )
        + "\n"
    )
