"""graftlint for the PyTorch port: an AST-based analyzer of the hazards
eager PyTorch has on this repo's hot paths (counterpart of
`alphatriangle_tpu/analysis/`, README's port section).

The JAX package's seven rules, under their names, scopes, pragma syntax
(`# graftlint: allow(rule) reason`) and resolution order (pragma, then
baseline, then reported), each restated for eager PyTorch
(`rules.py`): reads after an in-place update, host syncs in hot
modules, mixed device/host dispatches, hot dispatches outside a flight
bracket, debug artifacts, global-state RNG and untrapped exits.

Torch- and JAX-free by contract: `cli lint` runs in a preflight before a
card run, in images without a CUDA stack and beside a wedged card, like
`cli mem` / `cli doctor` (pinned by a subprocess import-guard test).
"""

from .baseline import (
    BASELINE_SCHEMA,
    apply_baseline,
    load_baseline,
    write_baseline,
)
from .engine import LINT_SCHEMA, LintReport, run_lint
from .model import Finding, Module
from .rules import RULE_NAMES, RULES

__all__ = [
    "BASELINE_SCHEMA",
    "LINT_SCHEMA",
    "Finding",
    "LintReport",
    "Module",
    "RULES",
    "RULE_NAMES",
    "apply_baseline",
    "load_baseline",
    "run_lint",
    "write_baseline",
]
