"""Lightweight intraprocedural dataflow for the port's graftlint rules
(counterpart of `alphatriangle_tpu/analysis/dataflow.py`).

Deliberately lexical: statements are ordered by source position, not by
control-flow path. That over-approximates "read after an in-place
update" across branches the same way a human skimming the function
does, and every rule's verdict is fixture-pinned so the approximation
can't drift silently.
"""

from __future__ import annotations

import ast

# `utils/transfer.fetch`, the port's `jax.device_get`: its result is on the host.
FETCH_NAMES = frozenset({"fetch", "transfer.fetch", "utils.transfer.fetch"})
# torch factories: a tensor on the default device (the host) unless
# `device=` names another.
TORCH_FACTORIES = frozenset({
    "tensor", "as_tensor", "zeros", "ones", "empty", "full", "arange", "linspace", "eye",
})


def attr_path(node: ast.AST) -> str | None:
    """Dotted path of a Name/Attribute chain ("self.states.score"),
    or None for anything that isn't a pure chain."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> str | None:
    """Dotted path of a call's callee, or None."""
    return attr_path(call.func)


def call_tail(call: ast.Call) -> str:
    """The callee's last name: `ops.backup_update(...)` -> backup_update,
    `x.cpu()` -> cpu; "" for anything else."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return ""


def keyword(call: ast.Call, name: str) -> ast.AST | None:
    """The value of keyword `name` in `call`, or None."""
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def strip_subscript(node: ast.AST) -> ast.AST:
    """x[i][j] -> x (subscripting doesn't change which object syncs)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return node


def assignment_targets(stmt: ast.stmt) -> list[str]:
    """Dotted paths bound by an assignment statement (tuple targets
    flattened); empty for non-assignments."""
    targets: list[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    out: list[str] = []
    for t in targets:
        if isinstance(t, (ast.Tuple, ast.List)):
            out.extend(p for e in t.elts if (p := attr_path(e)) is not None)
        else:
            p = attr_path(t)
            if p is not None:
                out.append(p)
    return out


def occurrences_after(
    func: ast.AST, path: str, end_line: int, end_col: int
) -> list[tuple[int, int, bool]]:
    """(line, col, is_store) events for `path` inside `func` strictly
    after (end_line, end_col), in source order. An Attribute chain
    event takes its ctx from the outermost link."""
    events: list[tuple[int, int, bool]] = []
    for node in ast.walk(func):
        if isinstance(node, (ast.Name, ast.Attribute)):
            if attr_path(node) != path:
                continue
            ctx = getattr(node, "ctx", None)
            pos = (node.lineno, node.col_offset)
            if pos <= (end_line, end_col):
                continue
            events.append(
                (node.lineno, node.col_offset, isinstance(ctx, ast.Store))
            )
    events.sort()
    return events


def _names_device(node: ast.AST) -> bool:
    """Does a `.to(...)` argument name a device: a name or attribute
    holding "dev" (`device`, `self.device`, `dev`), a `torch.device(...)`
    or a "cuda..." string?"""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    if isinstance(node, ast.Call):
        return call_name(node) == "torch.device"
    path = attr_path(node) or ""
    return "dev" in path.rsplit(".", 1)[-1]


class FunctionFacts:
    """Per-function name classification for placement checks: names
    bound to a known-device tensor and to a known-host one."""

    def __init__(self, func: ast.AST):
        self.committed: set[str] = set()  # known on the device
        self.host_known: set[str] = set()  # known on the host
        for stmt in ast.walk(func):
            if not isinstance(stmt, ast.Assign):
                continue
            names = assignment_targets(stmt)
            if not names:
                continue
            kind = self._classify(stmt.value)
            if kind == "committed":
                self.committed.update(names)
            elif kind == "host":
                self.host_known.update(names)

    @staticmethod
    def _classify(value: ast.AST) -> str | None:
        """committed: `.to(<device>)`, `.cuda()`, a torch factory with a
        `device=` other than "cpu"; host: `torch.from_numpy`, `np.*`, a
        torch factory without a device, `.cpu()` / `.numpy()` /
        `.astype()`, a fetch."""
        if not isinstance(value, ast.Call):
            return None
        name = call_name(value) or ""
        tail = call_tail(value)
        if tail == "cuda" or (
            tail == "to"
            and (any(_names_device(a) for a in value.args)
                 or keyword(value, "device") is not None)
        ):
            return "committed"
        if tail in ("cpu", "numpy", "astype") or name in FETCH_NAMES or name == "torch.from_numpy":
            return "host"
        root = name.split(".", 1)[0]
        if root in ("np", "numpy"):
            return "host"
        if root == "torch" and name.count(".") == 1 and tail in TORCH_FACTORIES:
            device = keyword(value, "device")
            if device is None or (
                isinstance(device, ast.Constant) and device.value == "cpu"
            ):
                return "host"
            return "committed"
        return None

    def classify_arg(self, arg: ast.AST) -> str | None:
        """committed / host / None(unknown) for one call argument."""
        if isinstance(arg, ast.Call):
            return self._classify(arg)
        path = attr_path(strip_subscript(arg))
        if path is None:
            return None
        if path in self.committed:
            return "committed"
        if path in self.host_known:
            return "host"
        return None
