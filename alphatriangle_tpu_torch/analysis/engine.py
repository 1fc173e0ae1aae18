"""graftlint engine of the port: walk a package tree, run the rule
catalog, fold pragmas + baseline, render text/JSON verdicts
(counterpart of `alphatriangle_tpu/analysis/engine.py`).

Exit-code contract (mirrored by `cli lint` and pinned in tests):
  0  clean (no findings, no stale baseline entries)
  1  findings, or stale baseline entries (suppressions may not rot)
  2  parse error (a file that doesn't parse can't be vouched for)

The JSON verdict is the JAX package's, schema and keys included.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

from .baseline import apply_baseline, load_baseline
from .model import Finding, Module
from .rules import RULE_NAMES, RULES

LINT_SCHEMA = "alphatriangle.lint.v1"

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache"}


@dataclass
class LintReport:
    root: str
    files_scanned: int = 0
    rules: list[str] = field(default_factory=list)
    findings: list[Finding] = field(default_factory=list)
    suppressed_pragma: int = 0
    suppressed_baseline: int = 0
    stale_baseline: list[dict] = field(default_factory=list)
    parse_errors: list[dict] = field(default_factory=list)

    @property
    def exit_code(self) -> int:
        if self.parse_errors:
            return 2
        if self.findings or self.stale_baseline:
            return 1
        return 0

    def as_dict(self) -> dict:
        # "schema" leads so a human tailing a log of verdicts sees what
        # the blob is before anything else.
        return {
            "schema": LINT_SCHEMA,
            "root": self.root,
            "files_scanned": self.files_scanned,
            "rules": self.rules,
            "findings": [f.as_dict() for f in self.findings],
            "suppressed": {
                "pragma": self.suppressed_pragma,
                "baseline": self.suppressed_baseline,
            },
            "stale_baseline": self.stale_baseline,
            "parse_errors": self.parse_errors,
            "exit_code": self.exit_code,
        }

    def to_json(self) -> str:
        return json.dumps(self.as_dict())

    def render(self) -> str:
        lines = []
        for f in self.findings:
            lines.append(
                f"{f.path}:{f.line}:{f.col + 1} [{f.rule}] {f.message}"
                f" ({f.context})"
            )
        for e in self.parse_errors:
            lines.append(f"{e['path']}: PARSE ERROR: {e['error']}")
        if self.stale_baseline:
            lines.append(
                "stale baseline entries (match no current finding — "
                "delete them from the baseline file):"
            )
            for e in self.stale_baseline:
                lines.append(
                    f"  {e.get('path')} [{e.get('rule')}] "
                    f"{e.get('key')}"
                )
        verdict = (
            "clean"
            if self.exit_code == 0
            else ("parse error" if self.exit_code == 2 else "dirty")
        )
        lines.append(
            f"graftlint: {verdict} — {len(self.findings)} finding(s), "
            f"{self.suppressed_pragma} pragma-allowed, "
            f"{self.suppressed_baseline} baselined, "
            f"{len(self.stale_baseline)} stale baseline entr"
            f"{'y' if len(self.stale_baseline) == 1 else 'ies'} "
            f"({self.files_scanned} files, "
            f"{len(self.rules)} rules)"
        )
        return "\n".join(lines)


def iter_source_files(root: Path) -> list[Path]:
    return sorted(
        p
        for p in root.rglob("*.py")
        if not any(part in _SKIP_DIRS for part in p.parts)
    )


def run_lint(
    root: Path | str,
    rule_names: "list[str] | None" = None,
    baseline_path: "Path | str | None" = None,
) -> LintReport:
    """Lint every .py under `root` with the selected rules."""
    root = Path(root)
    selected = [
        r for r in RULES if rule_names is None or r.name in rule_names
    ]
    if rule_names is not None:
        unknown = set(rule_names) - set(RULE_NAMES)
        if unknown:
            raise ValueError(
                f"unknown rule(s) {sorted(unknown)}; "
                f"available: {list(RULE_NAMES)}"
            )
    report = LintReport(root=str(root), rules=[r.name for r in selected])
    findings: list[Finding] = []
    for path in iter_source_files(root):
        try:
            mod = Module.load(path, root)
        except SyntaxError as e:
            report.parse_errors.append(
                {
                    "path": path.relative_to(root).as_posix(),
                    "error": f"{e.msg} (line {e.lineno})",
                }
            )
            continue
        report.files_scanned += 1
        for rule in selected:
            for finding in rule.check(mod):
                if mod.suppressed(finding):
                    report.suppressed_pragma += 1
                    continue
                findings.append(finding)
    entries = load_baseline(baseline_path)
    kept, suppressed, stale = apply_baseline(findings, entries)
    report.findings = sorted(
        kept, key=lambda f: (f.path, f.line, f.col, f.rule)
    )
    report.suppressed_baseline = len(suppressed)
    report.stale_baseline = stale
    return report
