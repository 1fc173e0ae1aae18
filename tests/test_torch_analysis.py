"""graftlint for the port (`alphatriangle_tpu_torch/analysis/`, `cli lint`)
against the JAX package's (`alphatriangle_tpu/analysis/`,
tests/test_analysis.py).

- Every rule, under its JAX name, has one fixture true positive and one
  near-miss true negative, restated for eager PyTorch (the hazards of
  `analysis/rules.py`'s table).
- Where detection does not depend on the framework (pdb and
  `breakpoint()`, global numpy and stdlib draws, untrapped exits) one
  fixture tree goes through both packages' lints: equal finding keys and
  equal `--json` verdicts apart from `root`.
- The engine's contracts: pragmas, the baseline (suppression, stale
  entries, line drift, a corrupt file), exit codes 0 / 1 / 2,
  `--write-baseline` round trip, and the default baseline lookup, which
  never reads the repository root's `lint_baseline.json` (the JAX
  package's keys).
- The port's package lints clean against its own baseline, and `cli
  lint` imports neither torch nor JAX (a subprocess import guard).
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from alphatriangle_tpu.analysis import run_lint as jax_run_lint
from alphatriangle_tpu.cli import main as jax_cli_main
from alphatriangle_tpu_torch.analysis import (
    BASELINE_SCHEMA,
    LINT_SCHEMA,
    RULE_NAMES,
    run_lint,
    write_baseline,
)
from alphatriangle_tpu_torch.analysis.rules import HOT_DISPATCHES, IN_PLACE_OPS
from alphatriangle_tpu_torch.cli import main as cli_main

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "alphatriangle_tpu_torch"


def make_tree(tmp_path, files, name="pkg") -> Path:
    """Write {relpath: source} under a fresh root."""
    root = tmp_path / name
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return root


def lint_tree(tmp_path, files, **kw):
    return run_lint(make_tree(tmp_path, files), **kw)


def hits(report, rule):
    return [f for f in report.findings if f.rule == rule]


def rules_hit(report):
    return {f.rule for f in report.findings}


def test_rule_names_are_the_jax_packages():
    from alphatriangle_tpu.analysis import RULE_NAMES as JAX_RULE_NAMES

    assert RULE_NAMES == JAX_RULE_NAMES and len(RULE_NAMES) == 7


# --- rule: use-after-donation (a read after an in-place update) ------------


IN_PLACE_BAD = """
    from ..ops import backup_update

    def wave(tree, parents, actions, new, rewards, node, action, active, returns):
        backup_update(tree.e_visits, tree.e_value, tree.children, tree.e_reward,
                      parents, actions, new, rewards, node, action, active, returns)
        return tree.e_visits.sum()
"""

IN_PLACE_GOOD = """
    from ..ops import backup_update

    def rebound(ev, val, ch, rw, parents, actions, new, rewards, node, action, active, returns):
        ev, val, ch, rw = backup_update(ev, val, ch, rw, parents, actions, new, rewards,
                                        node, action, active, returns)
        return ev.sum(), parents

    def other_args(tree, parents, actions, new, rewards, node, action, active, returns):
        backup_update(tree.e_visits, tree.e_value, tree.children, tree.e_reward,
                      parents, actions, new, rewards, node, action, active, returns)
        return parents, rewards
"""


class TestUseAfterDonation:
    def test_true_positive(self, tmp_path):
        r = lint_tree(tmp_path, {"mcts/w.py": IN_PLACE_BAD})
        found = hits(r, "use-after-donation")
        assert len(found) == 1
        assert "`tree.e_visits`" in found[0].message and "backup_update" in found[0].message
        assert found[0].context == "wave" and found[0].line == 7

    def test_true_negative_rebound_and_unmutated_args(self, tmp_path):
        r = lint_tree(tmp_path, {"mcts/w.py": IN_PLACE_GOOD})
        assert "use-after-donation" not in rules_hit(r)

    def test_ring_scatter_storage(self, tmp_path):
        src = """
            from .device_buffer import ring_scatter

            def ingest(buf, blocks, cap):
                count, pos, keep = ring_scatter(buf.storage, buf.pos, blocks, cap)
                old = buf.storage["grid"][pos]
                return count, old
        """
        r = lint_tree(tmp_path, {"rl/i.py": src})
        assert [f.line for f in hits(r, "use-after-donation")] == [6]
        assert IN_PLACE_OPS["ring_scatter"] == (0,)


# --- rule: host-sync-in-hot-path --------------------------------------------


class TestHostSyncInHotPath:
    def test_item_true_positive_in_hot_module(self, tmp_path):
        src = """
            def loop(metrics):
                return metrics.item()
        """
        r = lint_tree(tmp_path, {"rl/hot.py": src})
        assert "host-sync-in-hot-path" in rules_hit(r)

    def test_same_code_cold_module_is_clean(self, tmp_path):
        src = """
            def loop(metrics):
                return metrics.item()
        """
        r = lint_tree(tmp_path, {"stats/cold.py": src})
        assert "host-sync-in-hot-path" not in rules_hit(r)

    def test_shape_only_transfer(self, tmp_path):
        src = """
            def f(batch):
                n = int(batch["v"].cpu().shape[0])
                return n, batch["v"].shape[0]
        """
        r = lint_tree(tmp_path, {"serving/s.py": src})
        found = hits(r, "host-sync-in-hot-path")
        assert len(found) == 1 and "shape" in found[0].message

    def test_fragmented_field_fetch_and_one_finding_a_chain(self, tmp_path):
        src = """
            import numpy as np

            class S:
                def retire(self, slot):
                    score = self.states.score[slot].cpu()  # per field: flagged
                    local = np.asarray(self.buf)  # a host array: not flagged
                    both = self.x.cpu().numpy()  # one sync, one finding
                    return score, local, both
        """
        r = lint_tree(tmp_path, {"serving/t.py": src})
        found = hits(r, "host-sync-in-hot-path")
        assert [f.line for f in found] == [6, 8]
        assert "self.states.score" in found[0].message and "field by field" in found[0].message

    def test_fetch_flagged_and_pragma_allows(self, tmp_path):
        src = """
            from ..utils.transfer import fetch

            def step(out):
                a = fetch(out)
                b = fetch(out)  # graftlint: allow(host-sync-in-hot-path) the one deliberate fetch
                return a, b
        """
        r = lint_tree(tmp_path, {"mcts/m.py": src})
        found = hits(r, "host-sync-in-hot-path")
        assert len(found) == 1 and found[0].line == 5
        assert r.suppressed_pragma == 1

    def test_fences_flagged_events_and_beacons_clean(self, tmp_path):
        # The progress beacons (telemetry/device_stats.py emit_beacon) and
        # stream / event ordering never block the host: clean. Fences do.
        src = """
            import torch
            from ..telemetry.device_stats import emit_beacon

            def wave(k, side, done):
                emit_beacon("search_wave", k)
                done.record(side)
                torch.cuda.current_stream().wait_event(done)
                side.synchronize()
                torch.cuda.synchronize()
                return k
        """
        r = lint_tree(tmp_path, {"mcts/beacons.py": src})
        found = hits(r, "host-sync-in-hot-path")
        assert [f.line for f in found] == [9, 10]

    def test_nonzero_without_size_and_host_values(self, tmp_path):
        src = """
            import numpy as np
            import torch

            def rows(mask, m):
                a = mask.nonzero()
                b = torch.nonzero(mask, size=4, fill_value=0)
                c = np.nonzero(m)[0]
                d = np.arange(3).tolist()
                h = torch.zeros(3)
                return a, b, c, d, h.numpy(), torch.arange(4).tolist()
        """
        r = lint_tree(tmp_path, {"rl/rows.py": src})
        assert [f.line for f in hits(r, "host-sync-in-hot-path")] == [6]

    def test_training_loop_and_flywheel_are_hot(self, tmp_path):
        src = """
            def f(x):
                return x.item()
        """
        r = lint_tree(
            tmp_path,
            {"training/loop.py": src, "league/flywheel.py": src, "training/setup.py": src},
        )
        hot = [f.path for f in r.findings]
        assert "training/loop.py" in hot and "league/flywheel.py" in hot
        assert "training/setup.py" not in hot


# --- rule: mixed-placement-dispatch -----------------------------------------


MIXED_BAD = """
    import numpy as np
    import torch
    from ..ops import gather_rows

    def descend(stats, device):
        a = stats.to(device)
        idx = torch.from_numpy(np.zeros((2, 3), np.int32))
        return gather_rows(a, idx)
"""

MIXED_GOOD = """
    import numpy as np
    import torch
    from ..ops import gather_rows

    def descend(stats, device):
        a = stats.to(device)
        idx = torch.from_numpy(np.zeros((2, 3), np.int32)).to(device)
        return gather_rows(a, idx), gather_rows(stats, torch.zeros(2, 3, dtype=torch.int32))
"""


class TestMixedPlacementDispatch:
    def test_true_positive(self, tmp_path):
        r = lint_tree(tmp_path, {"mcts/d.py": MIXED_BAD})
        found = hits(r, "mixed-placement-dispatch")
        assert len(found) == 1
        assert "positions [0]" in found[0].message and "positions [1]" in found[0].message

    def test_all_on_the_device_is_clean(self, tmp_path):
        r = lint_tree(tmp_path, {"mcts/d.py": MIXED_GOOD})
        assert "mixed-placement-dispatch" not in rules_hit(r)

    def test_factories_by_device_keyword(self, tmp_path):
        src = """
            import torch
            from ..ops import count_below

            def draw(cum, device):
                u = torch.zeros(4, device=device)
                v = torch.zeros(4, device="cpu")
                return count_below(cum.cuda(), u), count_below(cum.cuda(), v)
        """
        r = lint_tree(tmp_path, {"rl/p.py": src})
        assert [f.line for f in hits(r, "mixed-placement-dispatch")] == [8]


# --- rule: unbracketed-hot-dispatch -----------------------------------------


UNBRACKETED_BAD = """
    class SelfPlayEngine:
        def play_chunk(self, t):
            return self._chunk(t)
"""

BRACKETED_GOOD = """
    from ..telemetry.flight import flight_span

    class SelfPlayEngine:
        def play_chunk(self, t):
            with flight_span(self.flight, "rollout", f"self_play_chunk/t{t}"):
                return self._chunk(t)

        def warm(self, t):
            return self._chunk(t)  # not a dispatch entry
"""

BEGIN_GOOD = """
    class Trainer:
        def _begin(self, program, run):
            span = self.flight.begin("learner", program)
            return run(), span
"""


class TestUnbracketedHotDispatch:
    def test_true_positive(self, tmp_path):
        r = lint_tree(tmp_path, {"rl/self_play.py": UNBRACKETED_BAD})
        found = hits(r, "unbracketed-hot-dispatch")
        assert len(found) == 1 and "'rollout'" in found[0].message
        assert found[0].context == "SelfPlayEngine.play_chunk"

    def test_bracketed_begin_and_other_methods_clean(self, tmp_path):
        r = lint_tree(tmp_path, {"rl/self_play.py": BRACKETED_GOOD, "rl/trainer.py": BEGIN_GOOD})
        assert "unbracketed-hot-dispatch" not in rules_hit(r)

    @pytest.mark.parametrize("entry", sorted(HOT_DISPATCHES))
    def test_every_dispatch_entry_covered(self, tmp_path, entry):
        path, qualname = entry
        program, work = HOT_DISPATCHES[entry]
        cls, meth = qualname.split(".")
        src = f"""
            class {cls}:
                def {meth}(self, run):
                    return {work}()
        """
        r = lint_tree(tmp_path, {path: src})
        found = hits(r, "unbracketed-hot-dispatch")
        assert len(found) == 1, entry
        r = lint_tree(tmp_path / "elsewhere", {"stats/cold.py": src})
        assert not hits(r, "unbracketed-hot-dispatch")


# --- rule: debug-artifact ----------------------------------------------------


class TestDebugArtifact:
    def test_true_positives(self, tmp_path):
        src = """
            import os
            import ipdb
            import torch

            def f(x):
                breakpoint()
                torch.autograd.set_detect_anomaly(True)
                with torch.autograd.detect_anomaly():
                    y = x + 1
                os.environ["CUDA_LAUNCH_BLOCKING"] = "1"
                os.environ.setdefault("CUDA_LAUNCH_BLOCKING", "1")
                return y
        """
        r = lint_tree(tmp_path, {"nn/dbg.py": src})
        assert [f.line for f in hits(r, "debug-artifact")] == [3, 7, 8, 9, 11, 12]

    def test_near_misses_are_clean(self, tmp_path):
        src = """
            import logging
            import os
            import torch

            logger = logging.getLogger(__name__)

            def f(x):
                logger.debug("x=%s", x)
                torch.autograd.set_detect_anomaly(False)
                blocking = os.environ.get("CUDA_LAUNCH_BLOCKING")
                return x, blocking
        """
        r = lint_tree(tmp_path, {"nn/dbg.py": src})
        assert "debug-artifact" not in rules_hit(r)

    def test_pdb_import(self, tmp_path):
        r = lint_tree(tmp_path, {"rl/p.py": "import pdb\n"})
        assert "debug-artifact" in rules_hit(r)


# --- rule: untracked-rng -----------------------------------------------------


class TestUntrackedRng:
    def test_global_draws_in_device_module(self, tmp_path):
        src = """
            import numpy as np
            import torch

            def noise(x, shape):
                torch.manual_seed(0)
                a = torch.rand(shape)
                x.uniform_(0.0, 1.0)
                return a, torch.multinomial(x, 1), np.random.randint(0, 4, shape)
        """
        r = lint_tree(tmp_path, {"mcts/r.py": src})
        assert [f.line for f in hits(r, "untracked-rng")] == [6, 7, 8, 9, 9]

    def test_seeded_generators_keys_and_cold_module_clean(self, tmp_path):
        seeded = """
            import numpy as np
            import torch
            from .. import rng

            def gen(x, seed, key):
                g = torch.Generator().manual_seed(seed)
                a = torch.rand(3, generator=g)
                x.uniform_(0.0, 1.0, generator=g)
                return a, np.random.default_rng(seed), rng.uniform(key, (3,))
        """
        cold = """
            import torch

            def noise(shape):
                return torch.rand(shape)
        """
        r = lint_tree(tmp_path, {"rl/g.py": seeded, "stats/c.py": cold})
        assert "untracked-rng" not in rules_hit(r)

    def test_stdlib_random_import(self, tmp_path):
        r = lint_tree(tmp_path, {"env/e.py": "import random\n"})
        assert "untracked-rng" in rules_hit(r)


# --- rule: untrapped-exit ----------------------------------------------------


class TestUntrappedExit:
    def test_true_positive_hot_path(self, tmp_path):
        src = """
            import sys

            def bail(metrics):
                if metrics["loss"] != metrics["loss"]:
                    sys.exit(1)
        """
        r = lint_tree(tmp_path, {"rl/bail.py": src})
        found = hits(r, "untrapped-exit")
        assert len(found) == 1 and "sys.exit" in found[0].message

    def test_true_negative_cold_module_and_whitelist(self, tmp_path):
        src = """
            import os, sys

            def die():
                os._exit(113)

            def give_up():
                sys.exit(115)
        """
        r = lint_tree(
            tmp_path,
            {"stats/report.py": src, "supervise/supervisor.py": src, "telemetry/flight.py": src},
        )
        assert "untrapped-exit" not in rules_hit(r)


# --- the framework-neutral rules against the JAX package's lint ---------------


NEUTRAL = {
    "rl/dbg.py": """
        import pdb

        def f(x):
            breakpoint()
            pdb.set_trace()
            return x
    """,
    "mcts/r.py": """
        import random
        import numpy as np

        def noise(shape):
            return np.random.randint(0, 4, shape), np.random.default_rng(0)
    """,
    "env/e.py": "from random import choice\n",
    "stats/c.py": """
        import numpy as np

        def noise(shape):
            return np.random.rand(*shape)
    """,
    "training/stop.py": """
        import os, sys

        def hard_stop():
            os._exit(3)

        def bail():
            sys.exit(1)  # graftlint: allow(untrapped-exit) the test's pragma
    """,
    "serving/s.py": """
        import sys

        def bail():
            sys.exit(2)
    """,
    "supervise/s.py": """
        import sys

        def give_up():
            sys.exit(115)
    """,
}


def test_framework_neutral_rules_agree_with_the_jax_lint(tmp_path, capsys):
    root = make_tree(tmp_path, NEUTRAL)
    port, jax = run_lint(root), jax_run_lint(root)
    keys = [f.key for f in port.findings]
    assert keys == [f.key for f in jax.findings]
    assert {f.rule for f in port.findings} == {"debug-artifact", "untracked-rng", "untrapped-exit"}
    assert len(keys) == 8 and port.suppressed_pragma == jax.suppressed_pragma == 1
    assert cli_main(["lint", str(root), "--json"]) == 1
    mine = json.loads(capsys.readouterr().out.strip())
    assert jax_cli_main(["lint", str(root), "--json"]) == 1
    theirs = json.loads(capsys.readouterr().out.strip())
    assert mine.pop("root") == theirs.pop("root") == str(root)
    assert mine == theirs


# --- engine: pragmas, baseline, exit codes --------------------------------------


ONE_PER_RULE = {
    "training/exit.py": """
        import sys

        def f(step):
            sys.exit(1)
    """,
    "mcts/inplace.py": IN_PLACE_BAD,
    "mcts/mixed.py": MIXED_BAD,
    "rl/self_play.py": UNBRACKETED_BAD,
    "serving/sync.py": """
        def f(x):
            return x.item()
    """,
    "nn/dbg.py": """
        def f(x):
            breakpoint()
            return x
    """,
    "mcts/rng.py": """
        import torch

        def f():
            return torch.rand(3)
    """,
}


class TestEngine:
    def test_one_violation_per_rule_tree(self, tmp_path):
        r = lint_tree(tmp_path, ONE_PER_RULE)
        assert rules_hit(r) == set(RULE_NAMES)
        assert r.exit_code == 1

    def test_rule_selector(self, tmp_path):
        r = lint_tree(tmp_path, ONE_PER_RULE, rule_names=["debug-artifact"])
        assert rules_hit(r) == {"debug-artifact"} and r.rules == ["debug-artifact"]

    def test_unknown_rule_raises(self, tmp_path):
        with pytest.raises(ValueError, match="unknown rule"):
            lint_tree(tmp_path, ONE_PER_RULE, rule_names=["nope"])

    def test_parse_error_exit_2(self, tmp_path):
        r = lint_tree(tmp_path, {"rl/broken.py": "def f(:\n"})
        assert r.exit_code == 2
        assert r.parse_errors and r.parse_errors[0]["path"] == "rl/broken.py"

    def test_clean_tree_exit_0(self, tmp_path):
        assert lint_tree(tmp_path, {"rl/ok.py": "X = 1\n"}).exit_code == 0

    def test_baseline_suppresses_then_stales(self, tmp_path):
        r = lint_tree(tmp_path, {"serving/sync.py": ONE_PER_RULE["serving/sync.py"]})
        assert r.exit_code == 1
        baseline = tmp_path / "baseline.json"
        write_baseline(baseline, r.findings)
        assert json.loads(baseline.read_text())["schema"] == BASELINE_SCHEMA
        r2 = run_lint(tmp_path / "pkg", baseline_path=baseline)
        assert r2.exit_code == 0 and r2.suppressed_baseline == 1
        (tmp_path / "pkg" / "serving" / "sync.py").write_text("def f(x):\n    return x\n")
        r3 = run_lint(tmp_path / "pkg", baseline_path=baseline)
        assert r3.exit_code == 1 and len(r3.stale_baseline) == 1 and not r3.findings

    def test_baseline_survives_line_drift(self, tmp_path):
        r = lint_tree(tmp_path, {"serving/sync.py": ONE_PER_RULE["serving/sync.py"]})
        baseline = tmp_path / "baseline.json"
        write_baseline(baseline, r.findings)
        p = tmp_path / "pkg" / "serving" / "sync.py"
        p.write_text("# header\n# more header\n" + p.read_text())
        r2 = run_lint(tmp_path / "pkg", baseline_path=baseline)
        assert r2.exit_code == 0 and r2.suppressed_baseline == 1

    def test_corrupt_baseline_raises(self, tmp_path):
        bad = tmp_path / "b.json"
        bad.write_text("{not json")
        with pytest.raises(ValueError, match="not valid JSON"):
            lint_tree(tmp_path, ONE_PER_RULE, baseline_path=bad)


# --- cli lint ----------------------------------------------------------------------


class TestCliLint:
    def test_exit_1_on_seeded_tree_and_json_schema(self, tmp_path, capsys):
        root = make_tree(tmp_path, ONE_PER_RULE)
        rc = cli_main(["lint", str(root), "--json"])
        out = json.loads(capsys.readouterr().out.strip())
        assert rc == 1 and list(out)[0] == "schema" and out["schema"] == LINT_SCHEMA
        assert {f["rule"] for f in out["findings"]} == set(RULE_NAMES)
        assert out["baseline_path"] is None and out["exit_code"] == 1

    def test_rule_selector_and_exit_codes(self, tmp_path, capsys):
        root = make_tree(tmp_path, ONE_PER_RULE)
        assert cli_main(["lint", str(root), "--rule", "debug-artifact"]) == 1
        assert cli_main(["lint", str(root), "--rule", "debug-artifact", "--rule", "untracked-rng"]) == 1
        assert cli_main(["lint", str(root), "--rule", "nope"]) == 2
        assert cli_main(["lint", str(make_tree(tmp_path, {"rl/ok.py": "X = 1\n"}, "clean"))]) == 0
        assert cli_main(["lint", str(make_tree(tmp_path, {"rl/b.py": "def f(:\n"}, "broken"))]) == 2
        assert cli_main(["lint", str(tmp_path / "missing")]) == 2

    def test_write_baseline_roundtrip(self, tmp_path, capsys):
        root = make_tree(tmp_path, ONE_PER_RULE)
        baseline = tmp_path / "lb.json"
        assert cli_main(["lint", str(root), "--baseline", str(baseline), "--write-baseline"]) == 0
        assert len(json.loads(baseline.read_text())["entries"]) == len(ONE_PER_RULE)
        capsys.readouterr()
        assert cli_main(["lint", str(root), "--baseline", str(baseline)]) == 0
        assert "baselined" in capsys.readouterr().out
        # Without --baseline, --write-baseline writes inside the tree,
        # where the default lookup then finds it.
        assert cli_main(["lint", str(root), "--write-baseline"]) == 0
        assert (root / "lint_baseline.json").exists()
        capsys.readouterr()
        assert cli_main(["lint", str(root), "--json"]) == 0
        out = json.loads(capsys.readouterr().out.strip())
        assert out["baseline_path"] == str(root / "lint_baseline.json")

    def test_default_baseline_never_the_parent_directorys(self, tmp_path, capsys):
        """A baseline beside the linted tree (the repository root's, for
        the port's package) holds the JAX package's keys: the port never
        reads it, where the JAX lookup would."""
        root = make_tree(tmp_path, {"serving/sync.py": ONE_PER_RULE["serving/sync.py"]})
        write_baseline(tmp_path / "lint_baseline.json", run_lint(root).findings)
        assert jax_cli_main(["lint", str(root)]) == 0
        capsys.readouterr()
        assert cli_main(["lint", str(root), "--json"]) == 1
        out = json.loads(capsys.readouterr().out.strip())
        assert out["baseline_path"] is None and len(out["findings"]) == 1

    def test_port_package_lints_clean(self, capsys):
        """The acceptance gate: the port's package and its own baseline
        give a clean verdict; the root's JAX baseline is not read."""
        assert cli_main(["lint", "--json"]) == 0
        out = json.loads(capsys.readouterr().out.strip())
        assert out["exit_code"] == 0 and out["root"] == str(PORT)
        assert out["baseline_path"] == str(PORT / "lint_baseline.json")
        assert not out["findings"] and not out["stale_baseline"] and out["files_scanned"] > 100
        rc = cli_main(["lint"])
        assert rc == 0 and "clean" in capsys.readouterr().out

    def test_cli_lint_never_imports_torch_or_jax(self):
        code = (
            "import builtins, sys\n"
            "real = builtins.__import__\n"
            "def guard(name, *a, **k):\n"
            "    for banned in ('torch', 'jax', 'alphatriangle_tpu'):\n"
            "        if name == banned or name.startswith(banned + '.'):\n"
            "            raise AssertionError('cli lint imported ' + name)\n"
            "    return real(name, *a, **k)\n"
            "builtins.__import__ = guard\n"
            "from alphatriangle_tpu_torch.cli import main\n"
            "sys.exit(main(['lint', '--json']))\n"
        )
        proc = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True, cwd=str(REPO), timeout=120,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        verdict = json.loads(proc.stdout.strip().splitlines()[-1])
        assert verdict["schema"] == LINT_SCHEMA and verdict["exit_code"] == 0
