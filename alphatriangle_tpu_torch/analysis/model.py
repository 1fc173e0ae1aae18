"""Core graftlint types of the port: findings, pragmas, parsed modules
(counterpart of `alphatriangle_tpu/analysis/model.py`).

The analyzer is a pure-stdlib `ast` pass (plus `telemetry.flight`'s
family table, itself torch-free): like `cli mem` and `cli doctor` it
runs beside a wedged card, in a preflight before a card run and in
images without a CUDA stack, so it imports neither torch nor JAX.
tests/test_torch_analysis.py pins that with a subprocess import guard.
The port's layout mirrors the JAX package's, so the same directories
are hot and device code.
"""

from __future__ import annotations

import ast
import hashlib
import re
from dataclasses import dataclass, field
from pathlib import Path

# Modules whose per-iteration loops are launch-latency critical: a stray
# host sync here drains the card's queue and stalls the next launches.
# Directories cover the device subsystems; the two named files are the
# host orchestrators whose bodies run once per iteration.
HOT_PATH_DIRS = ("rl", "mcts", "serving", "ops")
HOT_PATH_FILES = ("training/loop.py", "league/flywheel.py")

# Modules whose code runs on (or feeds) the card: randomness here must
# come from the port's keys (`rng.PRNGKey`), a seeded `torch.Generator`
# or a seeded np Generator. Global-state draws (`torch.manual_seed`,
# `torch.rand` without a generator, `np.random.*`, stdlib `random`) are
# shared by every thread and stream, so their order, and with it a run,
# changes with the threads' timing.
DEVICE_CODE_DIRS = ("rl", "mcts", "serving", "ops", "nn", "env", "parallel")

_PRAGMA_RE = re.compile(r"#\s*graftlint:\s*allow\(([\w\-, ]+)\)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str  # root-relative posix path
    line: int
    col: int
    message: str
    context: str = "<module>"  # enclosing def/class qualname

    @property
    def key(self) -> str:
        """Baseline identity: stable across line drift (keys on the
        enclosing scope + the offending line's text, not its number)."""
        return f"{self.rule}:{self.path}:{self.context}:{self.text_hash}"

    # text_hash is attached by the engine once the source is at hand;
    # frozen dataclass -> stash via object.__setattr__ in with_text().
    text_hash: str = ""

    def with_text(self, line_text: str) -> "Finding":
        digest = hashlib.sha1(line_text.strip().encode()).hexdigest()[:10]
        return Finding(
            rule=self.rule,
            path=self.path,
            line=self.line,
            col=self.col,
            message=self.message,
            context=self.context,
            text_hash=digest,
        )

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "context": self.context,
            "key": self.key,
        }


def parse_pragmas(lines: list[str]) -> dict[int, set[str]]:
    """1-based line -> set of allowed rule names.

    `# graftlint: allow(rule-a, rule-b)` on (or immediately above) the
    offending line suppresses those rules there. Free text after the
    closing paren is welcome — state WHY the hazard is deliberate.
    """
    out: dict[int, set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = _PRAGMA_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


@dataclass
class Module:
    """One parsed source file plus the lookups every rule needs."""

    path: Path
    relpath: str  # posix, relative to the scan root
    source: str
    tree: ast.AST
    lines: list[str] = field(default_factory=list)
    pragmas: dict[int, set[str]] = field(default_factory=dict)
    parents: dict[ast.AST, ast.AST] = field(default_factory=dict)

    @classmethod
    def load(cls, path: Path, root: Path) -> "Module":
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
        lines = source.splitlines()
        mod = cls(
            path=path,
            relpath=path.relative_to(root).as_posix(),
            source=source,
            tree=tree,
            lines=lines,
            pragmas=parse_pragmas(lines),
        )
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                mod.parents[child] = parent
        return mod

    # --- classification ---------------------------------------------------

    @property
    def top_dir(self) -> str:
        return self.relpath.split("/", 1)[0] if "/" in self.relpath else ""

    @property
    def is_hot_path(self) -> bool:
        return self.top_dir in HOT_PATH_DIRS or self.relpath in HOT_PATH_FILES

    @property
    def is_device_code(self) -> bool:
        return self.top_dir in DEVICE_CODE_DIRS

    # --- lookups ----------------------------------------------------------

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def enclosing_context(self, node: ast.AST) -> str:
        """Qualname of the innermost enclosing def/class, or <module>."""
        names: list[str] = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                names.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(names)) or "<module>"

    def enclosing_function(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None

    def enclosing_statement(self, node: ast.AST) -> ast.stmt:
        cur: ast.AST = node
        while not isinstance(cur, ast.stmt):
            nxt = self.parents.get(cur)
            if nxt is None:
                break
            cur = nxt
        return cur  # type: ignore[return-value]

    def suppressed(self, finding: Finding, node: ast.AST | None = None) -> bool:
        """Pragma check: the finding line, the line above it, or (for
        multi-line statements) the statement's end line."""
        candidates = {finding.line, finding.line - 1}
        if node is not None:
            end = getattr(node, "end_lineno", None)
            if end:
                candidates.add(end)
        for ln in candidates:
            rules = self.pragmas.get(ln)
            if rules and finding.rule in rules:
                return True
        return False
