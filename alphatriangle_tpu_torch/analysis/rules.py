"""graftlint rule catalog of the port: the JAX package's seven rules
(`alphatriangle_tpu/analysis/rules.py`), under their names, scopes and
pragma, each restated for the hazard eager PyTorch has in its place.

| Rule | What it flags in the port |
|---|---|
| use-after-donation | a read of a tensor after it went to a mutated position of an in-place op (`IN_PLACE_OPS`), not rebound by the call's own assignment: the reader sees the new values where it expected the old (the port updates in place where JAX donates) |
| host-sync-in-hot-path | in hot modules, blocking device->host syncs: `.item()`, `.cpu()` / `.tolist()` / `.numpy()` of a tensor, `torch.cuda.synchronize`, `Stream` / `Event.synchronize()`, `nonzero()` without `size=`, `utils/transfer.fetch`; shape-only and per-field fetches |
| mixed-placement-dispatch | a kernel dispatcher or hot entry called with known-device and known-host tensors together: a hidden copy a call, and the route follows one tensor's device |
| unbracketed-hot-dispatch | a hot dispatch entry (`HOT_DISPATCHES`) whose device work sits outside its `flight_span` / `flight.begin` bracket |
| debug-artifact | `breakpoint()`, `pdb` / `ipdb`, anomaly detection left on, `CUDA_LAUNCH_BLOCKING` set from code |
| untracked-rng | in device-code modules, global-state draws: `torch.manual_seed`, torch draws without `generator=`, global `np.random.*`, stdlib `random` |
| untrapped-exit | bare `sys.exit` / `os._exit` in hot-path or training modules outside the sanctioned exiters |

Every rule yields `Finding`s from a parsed `Module`; each has a
fixture-pinned true positive AND a near-miss true negative in
tests/test_torch_analysis.py. Where a finding's hazard does not depend
on the framework (pdb and `breakpoint()`, global numpy and stdlib draws,
exits) its message is the JAX package's, word for word, so both lints
give equal verdicts on such code.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..telemetry.flight import program_family
from .dataflow import (
    FETCH_NAMES,
    FunctionFacts,
    assignment_targets,
    attr_path,
    call_name,
    call_tail,
    keyword,
    occurrences_after,
    strip_subscript,
)
from .model import Finding, Module

# The dispatch families the flight recorder brackets (plus the fleet
# router's host-side route bracket): every dispatch of one of these must
# sit inside a FlightRecorder intent/seal bracket, or a wedge inside it
# is invisible to `cli doctor`.
FLIGHT_FAMILIES = ("rollout", "learner", "megastep", "serve", "fleet", "reuse")

# The port's in-place ops, by the callee's last name: the argument
# positions each one updates in place where the JAX op returns new
# arrays from donated ones.
IN_PLACE_OPS: dict[str, tuple[int, ...]] = {
    # ops/mcts_backup.py: the four (B, N, A) edge planes.
    "backup_update": (0, 1, 2, 3),
    "backup_update_cuda": (0, 1, 2, 3),
    "backup_update_plain": (0, 1, 2, 3),
    # rl/device_buffer.py: the ring's storage columns.
    "ring_scatter": (0,),
}

# The hot dispatch entries: (module, qualname) -> (program name, the call
# in it that does the device work). The program name's family
# (`program_family`) must be a flight family.
HOT_DISPATCHES: dict[tuple[str, str], tuple[str, str]] = {
    ("rl/self_play.py", "SelfPlayEngine.play_chunk"): ("self_play_chunk/", "self._chunk"),
    ("rl/megastep.py", "MegastepRunner.run_megastep"): ("megastep/", "self._impl"),
    ("rl/trainer.py", "Trainer._begin"): ("learner_step", "run"),
    ("serving/service.py", "PolicyService.dispatch"): ("serve/", "self._search_step"),
    ("serving/router.py", "ReplicaRouter.route"): ("fleet/route", "self._attempt_loop"),
}

# The kernel dispatchers (`ops/__init__.py`) and the hot entries: calls
# whose tensor arguments must share a placement.
DISPATCHERS = frozenset(
    {"gather_rows", "backup_update", "count_below", "per_sample", "subtree_promote"}
    | {qualname.rsplit(".", 1)[-1] for _, qualname in HOT_DISPATCHES}
)

# np.random constructors that ARE tracked (explicit seeded generators).
_TRACKED_NP_RANDOM = {"default_rng", "Generator", "SeedSequence", "PCG64", "Philox"}
# torch draws that take `generator=`; without one they read the global state.
_TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like", "randint_like",
    "multinomial", "bernoulli", "normal", "poisson",
}
_TORCH_SEEDS = {
    "torch.manual_seed", "torch.seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.random.manual_seed",
}
# In-place tensor draws that take `generator=`.
_INPLACE_DRAWS = {
    "uniform_", "normal_", "random_", "exponential_", "bernoulli_", "geometric_", "cauchy_",
    "log_normal_",
}
_NP_FETCH = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}


class Rule:
    name: str = ""
    description: str = ""

    def check(self, mod: Module) -> Iterator[Finding]:
        raise NotImplementedError


def _finding(rule: Rule, mod: Module, node: ast.AST, message: str) -> Finding:
    f = Finding(
        rule=rule.name,
        path=mod.relpath,
        line=node.lineno,
        col=node.col_offset,
        message=message,
        context=mod.enclosing_context(node),
    )
    return f.with_text(mod.line_text(node.lineno))


def _qualname(mod: Module, func: ast.AST) -> str:
    ctx = mod.enclosing_context(func)
    return func.name if ctx == "<module>" else f"{ctx}.{func.name}"


class UseAfterDonation(Rule):
    name = "use-after-donation"
    description = (
        "A tensor passed at a mutated position of an in-place op is read "
        "again afterwards without being rebound: the read sees the "
        "updated values (the port updates in place where JAX donates)."
    )

    def check(self, mod: Module) -> Iterator[Finding]:
        for call in ast.walk(mod.tree):
            if not isinstance(call, ast.Call):
                continue
            callee = call_tail(call)
            positions = IN_PLACE_OPS.get(callee)
            if not positions:
                continue
            func = mod.enclosing_function(call)
            if func is None:
                continue
            stmt = mod.enclosing_statement(call)
            rebound = set(assignment_targets(stmt))
            for pos in positions:
                if pos >= len(call.args):
                    continue
                arg = attr_path(call.args[pos])
                if arg is None or arg in rebound:
                    continue  # expression arg, or rebound by the call
                end = (
                    getattr(stmt, "end_lineno", stmt.lineno),
                    getattr(stmt, "end_col_offset", 0),
                )
                events = occurrences_after(func, arg, end[0], end[1])
                if events and not events[0][2]:  # first event is a Load
                    line, col, _ = events[0]
                    f = Finding(
                        rule=self.name,
                        path=mod.relpath,
                        line=line,
                        col=col,
                        message=(
                            f"`{arg}` was updated in place by `{callee}` (arg "
                            f"{pos}, line {call.lineno}) and is read here "
                            "afterwards: the read sees the new values — "
                            "rebind the call's result over it, or copy it "
                            "before the call if the old values are meant"
                        ),
                        context=mod.enclosing_context(call),
                    )
                    yield f.with_text(mod.line_text(line))


class HostSyncInHotPath(Rule):
    name = "host-sync-in-hot-path"
    description = (
        "Blocking device->host sync inside a launch-latency-critical "
        "module (.item(), .cpu() / .tolist() / .numpy() of a tensor, "
        "torch.cuda.synchronize, Stream / Event.synchronize(), nonzero() "
        "without size=, utils/transfer.fetch, shape-only and per-field "
        "fetches)."
    )

    def check(self, mod: Module) -> Iterator[Finding]:
        if not mod.is_hot_path:
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node) or ""
            tail = call_tail(node)
            method = isinstance(node.func, ast.Attribute)
            if method and tail == "item" and not node.args:
                yield _finding(
                    self, mod, node,
                    ".item() forces a blocking device sync per scalar "
                    "— batch the fetch (one utils/transfer.fetch) outside "
                    "the hot loop",
                )
            elif method and tail == "synchronize":
                yield _finding(
                    self, mod, node,
                    f"{name or '.synchronize'}() waits for the card and "
                    "stalls the launch queue — only benchmarks should "
                    "fence; order streams with events instead",
                )
            elif (
                tail == "nonzero"
                and keyword(node, "size") is None
                and name.split(".", 1)[0] not in ("np", "numpy")
            ):
                yield _finding(
                    self, mod, node,
                    "nonzero() without size= syncs to learn its output's "
                    "length — pass size= (and fill_value=) or keep a mask",
                )
            elif name in FETCH_NAMES:
                yield from self._fetch(mod, node, f"{name}()", node.args[0] if node.args else None)
            elif name in _NP_FETCH:
                yield from self._fetch(mod, node, name, node.args[0] if node.args else None,
                                       generic=False)
            elif method and tail in ("cpu", "tolist", "numpy") and not node.args:
                receiver = node.func.value
                if _on_host(mod, receiver):
                    continue  # a host tensor, or the fetch below it syncs
                yield from self._fetch(mod, node, f".{tail}()", receiver)

    def _fetch(self, mod, node, what, target, generic=True):
        """A fetch of `target` by `what`: shape-only, per-field (a
        `self.a.b` chain), or (`generic`) a fetch in a hot module."""
        parent = mod.parents.get(node)
        if isinstance(parent, ast.Attribute) and parent.attr == "shape":
            yield _finding(
                self, mod, node,
                f"{what} then .shape transfers the whole tensor to read "
                "static metadata — use x.shape directly (no sync)",
            )
            return
        path = attr_path(strip_subscript(target)) if target is not None else None
        parts = (path or "").split(".")
        if parts[0] == "self" and len(parts) >= 3:
            yield _finding(
                self, mod, node,
                f"{what} of {path}… fetches device state field by field — "
                "batch the reads into ONE utils/transfer.fetch of a tuple",
            )
        elif generic:
            yield _finding(
                self, mod, node,
                f"{what} in a hot module blocks on the card — if this IS "
                "the one deliberate fetch of the iteration, mark it "
                "`# graftlint: allow(host-sync-in-hot-path)` with the "
                "reason; otherwise batch it",
            )


def _on_host(mod: Module, node: ast.AST) -> bool:
    """Is `node` known to live on the host: a call chain through a host
    value (`.cpu()`, `.numpy()`, `.astype()`, a fetch, np.*, a torch
    factory without a device), or a name the function bound to one?"""
    cur = strip_subscript(node)
    while isinstance(cur, ast.Call):
        if FunctionFacts._classify(cur) == "host":
            return True
        if not isinstance(cur.func, ast.Attribute):
            return False
        cur = strip_subscript(cur.func.value)
    path = attr_path(cur)
    func = mod.enclosing_function(node)
    return path is not None and func is not None and path in FunctionFacts(func).host_known


class MixedPlacementDispatch(Rule):
    name = "mixed-placement-dispatch"
    description = (
        "A kernel dispatcher or hot entry called with known-device tensors "
        "and known-host ones together: the host ones cost a hidden copy a "
        "call, and the dispatcher routes by one tensor's device."
    )

    def check(self, mod: Module) -> Iterator[Finding]:
        for func in ast.walk(mod.tree):
            if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            facts: FunctionFacts | None = None
            for call in ast.walk(func):
                if not isinstance(call, ast.Call):
                    continue
                callee = call_tail(call)
                if callee not in DISPATCHERS or len(call.args) < 2:
                    continue
                if facts is None:
                    facts = FunctionFacts(func)
                kinds = [facts.classify_arg(a) for a in call.args]
                if "committed" in kinds and "host" in kinds:
                    device = [i for i, k in enumerate(kinds) if k == "committed"]
                    host = [i for i, k in enumerate(kinds) if k == "host"]
                    yield _finding(
                        self, mod, call,
                        f"call to `{call_name(call) or callee}` mixes device "
                        f"tensors (positions {device}) with host tensors "
                        f"(positions {host}) — move every argument to the "
                        "card up front: a host tensor costs a hidden copy a "
                        "call, and the dispatcher routes by one tensor's "
                        "device",
                    )


class UnbracketedHotDispatch(Rule):
    name = "unbracketed-hot-dispatch"
    description = (
        "A hot dispatch entry (rollout/learner/megastep/serve/fleet) whose "
        "device work runs outside a FlightRecorder intent/seal bracket — "
        "a wedge inside it would be invisible to `cli doctor`."
    )

    def check(self, mod: Module) -> Iterator[Finding]:
        entries = {
            qualname: (program, work)
            for (path, qualname), (program, work) in HOT_DISPATCHES.items()
            if path == mod.relpath and program_family(program) in FLIGHT_FAMILIES
        }
        if not entries:
            return
        for func in ast.walk(mod.tree):
            if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            entry = entries.get(_qualname(mod, func))
            if entry is None:
                continue
            program, work = entry
            for call in ast.walk(func):
                if not isinstance(call, ast.Call) or call_name(call) != work:
                    continue
                if self._bracketed(mod, call):
                    continue
                yield _finding(
                    self, mod, call,
                    f"`{work}` dispatches flight family "
                    f"'{program_family(program)}' outside a "
                    "flight_span()/flight.begin() bracket — a wedge here "
                    "leaves no intent record for `cli doctor` to classify",
                )

    @staticmethod
    def _bracketed(mod: Module, call: ast.Call) -> bool:
        # (a) lexically inside `with flight_span(...)`
        cur = mod.parents.get(call)
        while cur is not None:
            if isinstance(cur, ast.With):
                for item in cur.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call):
                        n = call_name(expr) or ""
                        if n.split(".")[-1] == "flight_span":
                            return True
            cur = mod.parents.get(cur)
        # (b) a `<...>flight.begin(...)` earlier in the same function
        # (the begin/finish seal pattern in rl/trainer.py)
        func = mod.enclosing_function(call)
        if func is None:
            return False
        for node in ast.walk(func):
            if (
                isinstance(node, ast.Call)
                and node.lineno <= call.lineno
                and (call_name(node) or "").endswith("flight.begin")
            ):
                return True
        return False


def _environ_key(node: ast.AST) -> str | None:
    """The constant key of `os.environ[KEY]`, or None."""
    if (
        isinstance(node, ast.Subscript)
        and attr_path(node.value) in ("os.environ", "environ")
        and isinstance(node.slice, ast.Constant)
    ):
        return node.slice.value
    return None


class DebugArtifact(Rule):
    name = "debug-artifact"
    description = (
        "Debug scaffolding left in the program: breakpoint()/pdb/ipdb "
        "wedge an unattended card run forever; anomaly detection and "
        "CUDA_LAUNCH_BLOCKING serialize every launch."
    )

    def check(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                modname = (
                    node.module
                    if isinstance(node, ast.ImportFrom)
                    else ",".join(a.name for a in node.names)
                )
                names = (modname or "").split(",")
                if "pdb" in names or "ipdb" in names:
                    yield _finding(
                        self, mod, node,
                        f"{'pdb' if 'pdb' in names else 'ipdb'} import — an "
                        "unattended run hitting this wedges the window until "
                        "the watchdog kills it",
                    )
                continue
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    if _environ_key(target) == "CUDA_LAUNCH_BLOCKING":
                        yield self._launch_blocking(mod, node)
                continue
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node) or ""
            if name == "breakpoint":
                yield _finding(
                    self, mod, node, "breakpoint() call — hangs any "
                    "non-interactive run"
                )
            elif name.startswith(("pdb.", "ipdb.")):
                yield _finding(
                    self, mod, node, f"{name} call — hangs any "
                    "non-interactive run"
                )
            elif name.endswith("autograd.set_detect_anomaly") and not (
                node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value is False
            ):
                yield self._anomaly(mod, node, name)
            elif name.endswith("autograd.detect_anomaly"):
                yield self._anomaly(mod, node, name)
            elif (
                name in ("os.environ.setdefault", "os.putenv", "environ.setdefault")
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "CUDA_LAUNCH_BLOCKING"
            ):
                yield self._launch_blocking(mod, node)

    def _anomaly(self, mod, node, name):
        return _finding(
            self, mod, node,
            f"{name} left on — every backward op then checks for NaN "
            "and records a traceback, syncing and slowing each step",
        )

    def _launch_blocking(self, mod, node):
        return _finding(
            self, mod, node,
            "CUDA_LAUNCH_BLOCKING set from code — every launch then waits "
            "for the card; set it by hand when debugging, never in the "
            "program",
        )


class UntrackedRng(Rule):
    name = "untracked-rng"
    description = (
        "Global-state RNG in device-code modules (torch.manual_seed, torch "
        "draws without generator=, np.random.*, stdlib random): shared by "
        "every thread and stream, so a run changes with their timing — "
        "use the port's keys (rng.PRNGKey) or a seeded generator."
    )

    def check(self, mod: Module) -> Iterator[Finding]:
        if not mod.is_device_code:
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = (
                    [node.module]
                    if isinstance(node, ast.ImportFrom)
                    else [a.name for a in node.names]
                )
                if "random" in names:
                    yield _finding(
                        self,
                        mod,
                        node,
                        "stdlib `random` imported in a device-code module "
                        "— its global state never enters a program key; "
                        "thread a jax PRNG key instead",
                    )
                continue
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node) or ""
            parts = name.split(".")
            if (
                len(parts) >= 3
                and parts[0] in ("np", "numpy")
                and parts[1] == "random"
                and parts[2] not in _TRACKED_NP_RANDOM
            ):
                yield _finding(
                    self,
                    mod,
                    node,
                    f"{name} uses numpy's GLOBAL rng — seedable but "
                    "shared across threads and invisible to cache keys; "
                    "use np.random.default_rng(seed) or a jax key",
                )
            elif name in _TORCH_SEEDS:
                yield _finding(
                    self, mod, node,
                    f"{name} seeds torch's GLOBAL generator — every thread "
                    "and stream draws from it; draw from the port's keys "
                    "(rng.PRNGKey) or a seeded torch.Generator",
                )
            elif (
                (
                    (len(parts) == 2 and parts[0] == "torch" and parts[1] in _TORCH_DRAWS)
                    or (isinstance(node.func, ast.Attribute)
                        and call_tail(node) in _INPLACE_DRAWS)
                )
                and keyword(node, "generator") is None
            ):
                yield _finding(
                    self, mod, node,
                    f"{name or call_tail(node)} without generator= draws from "
                    "torch's GLOBAL generator, shared by every thread and "
                    "stream — pass a seeded torch.Generator or draw from "
                    "the port's keys (rng.PRNGKey)",
                )


class UntrappedExit(Rule):
    name = "untrapped-exit"
    description = (
        "Bare sys.exit/os._exit in a hot-path or training module — it "
        "bypasses the emergency-checkpoint/preemption path (loop.run's "
        "finally) and the run dies without spilling state. Exiting is "
        "the watchdog's and the supervisor's job (telemetry/flight.py, "
        "supervise/)."
    )

    # The sanctioned exiters: the dispatch watchdog (os._exit is the
    # POINT — the thread that would run shutdown is the wedged one) and
    # the supervisor parent, which owns process lifecycle.
    _WHITELIST_DIRS = ("supervise",)
    _WHITELIST_FILES = ("telemetry/flight.py",)

    def check(self, mod: Module) -> Iterator[Finding]:
        in_scope = mod.is_hot_path or mod.top_dir == "training"
        if not in_scope:
            return
        if (
            mod.top_dir in self._WHITELIST_DIRS
            or mod.relpath in self._WHITELIST_FILES
        ):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node) or ""
            if name in ("sys.exit", "os._exit"):
                yield _finding(
                    self,
                    mod,
                    node,
                    f"{name} in a hot-path/training module skips the "
                    "emergency checkpoint + buffer spill + flight flush "
                    "(loop.run's finally) — return a LoopStatus / raise "
                    "instead and let runner.EXIT_CODES map it",
                )


RULES: tuple[Rule, ...] = (
    UseAfterDonation(),
    HostSyncInHotPath(),
    MixedPlacementDispatch(),
    UnbracketedHotDispatch(),
    DebugArtifact(),
    UntrackedRng(),
    UntrappedExit(),
)

RULE_NAMES = tuple(r.name for r in RULES)
