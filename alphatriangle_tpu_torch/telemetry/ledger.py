"""Per-run metrics ledger: counterpart of `alphatriangle_tpu/telemetry/
ledger.py`, with the same record formats, so either package reads the
other's `metrics.jsonl`, `fleet.jsonl` and flight rings.

Every utilization tick (`kind: "util"`) and every fleet decision
(`kind: "fleet"`) is appended as one JSON line. Each `append` opens the
file, writes one complete line, flushes and closes: a crash mid-write
leaves at most one torn final line, which the readers skip and the next
process's first append terminates. Rotation renames `metrics.jsonl` ->
`.1` -> `.2` between appends, so no record spans files. Stdlib only: a
reader beside a wedged card never imports torch.
"""

import json
import logging
import os
import threading
import time
from pathlib import Path

logger = logging.getLogger(__name__)

METRICS_FILENAME = "metrics.jsonl"
PROM_FILENAME = "metrics.prom"

# Rotation defaults: ~16 MiB per file, 2 rotated generations kept. A
# tick is a few hundred bytes, so this bounds the run dir at ~50 MiB of
# ledger while still holding days of 1 Hz ticks.
DEFAULT_MAX_BYTES = 16 * 1024 * 1024
DEFAULT_KEEP = 2


class MetricsLedger:
    """Append-only JSONL writer with size-based rotation.

    Stateless between appends (open/write/flush/close per record): the
    single-writer training loop appends a few records per second at
    most, and statelessness is what makes the crash story trivial —
    there is never an open handle holding unflushed records.
    """

    def __init__(
        self,
        path: Path | str,
        max_bytes: int = DEFAULT_MAX_BYTES,
        keep: int = DEFAULT_KEEP,
    ) -> None:
        self.path = Path(path)
        self.max_bytes = max_bytes
        self.keep = keep
        # First append of this process checks whether a previous
        # process died mid-write and left a torn (newline-less) tail;
        # if so the tail is terminated first, so OUR first record does
        # not glue onto it and vanish with it.
        self._tail_checked = False
        # Threads of one process (the overlapped loop's producers and its
        # learner share a flight ring) append and rotate one at a time.
        self._lock = threading.Lock()

    def append(self, record: dict) -> bool:
        """Append one record as a complete JSON line; True on success.

        Failures are logged and swallowed — the ledger is observability,
        never a reason to kill a training run.
        """
        try:
            line = json.dumps(record, default=str) + "\n"
        except (TypeError, ValueError):
            logger.exception("ledger record not serializable; dropped")
            return False
        try:
            with self._lock:
                self._maybe_rotate(len(line))
                self.path.parent.mkdir(parents=True, exist_ok=True)
                if not self._tail_checked:
                    self._tail_checked = True
                    if self._tail_is_torn():
                        line = "\n" + line
                with self.path.open("a") as f:
                    f.write(line)
                    f.flush()
            return True
        except OSError:
            logger.exception("ledger append to %s failed", self.path)
            return False

    def _tail_is_torn(self) -> bool:
        """True when the file ends without a newline (a prior process
        died mid-write). Checked once per process, not per append: a
        single writer always leaves its own appends terminated."""
        try:
            with self.path.open("rb") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() == 0:
                    return False
                f.seek(-1, os.SEEK_END)
                return f.read(1) != b"\n"
        except OSError:
            return False

    def _maybe_rotate(self, incoming: int) -> None:
        """Shift `metrics.jsonl` -> `.1` -> ... -> `.keep` when the next
        append would cross `max_bytes`. Renames only — no record is
        rewritten, so a crash between renames loses nothing."""
        if self.max_bytes <= 0:
            return
        try:
            size = self.path.stat().st_size
        except OSError:
            return
        if size + incoming <= self.max_bytes:
            return
        if self.keep <= 0:
            self.path.unlink(missing_ok=True)
            return
        oldest = self.path.with_name(self.path.name + f".{self.keep}")
        oldest.unlink(missing_ok=True)
        for i in range(self.keep - 1, 0, -1):
            src = self.path.with_name(self.path.name + f".{i}")
            if src.exists():
                src.replace(self.path.with_name(self.path.name + f".{i + 1}"))
        self.path.replace(self.path.with_name(self.path.name + ".1"))

    def close(self) -> None:
        """No-op (no persistent handle); kept for lifecycle symmetry."""


def ledger_paths(path: Path | str) -> list[Path]:
    """Ledger files for `path`, oldest rotation first, live file last."""
    path = Path(path)
    rotated = []
    i = 1
    while True:
        p = path.with_name(path.name + f".{i}")
        if not p.exists():
            break
        rotated.append(p)
        i += 1
    out = list(reversed(rotated))
    if path.exists():
        out.append(path)
    return out


def iter_jsonl_records(path: Path | str, kinds: "set[str] | None" = None):
    """Yield parsed dict records from ONE JSONL file, skipping torn/junk
    lines. The single tolerant reader under every crash-safe artifact
    here: the metrics ledger walks it per rotation, and the dispatch
    flight ring (telemetry/flight.py) reads through it instead of
    duplicating the torn-tail handling."""
    try:
        with Path(path).open("r", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn write / junk byte: skip, never raise
                if not isinstance(rec, dict):
                    continue
                if kinds is not None and rec.get("kind") not in kinds:
                    continue
                yield rec
    except OSError:
        return


def iter_ledger_records(path: Path | str, kinds: "set[str] | None" = None):
    """Yield parsed records across rotations, skipping torn/junk lines."""
    for p in ledger_paths(path):
        yield from iter_jsonl_records(p, kinds=kinds)


def read_ledger(path: Path | str, kinds: "set[str] | None" = None) -> list[dict]:
    """All parseable records (optionally filtered by `kind`), in order."""
    return list(iter_ledger_records(path, kinds=kinds))


def resolve_ledger_path(target: Path | str) -> "Path | None":
    """Map a run dir / ledger file / arbitrary path to its ledger file."""
    target = Path(target)
    if target.is_dir():
        target = target / METRICS_FILENAME
    return target if target.exists() else None


# --- Prometheus textfile export -----------------------------------------

_PROM_HELP = {
    "learner_steps_per_sec": "Learner SGD steps per second (tick window)",
    "moves_per_sec": "Self-play experiences produced per second",
    "games_per_hour": "Self-play episodes completed per hour",
    "sims_per_sec": "MCTS simulations per second",
    "step_time_ms": "Mean learner step time over the tick window, ms",
    "tflops_per_sec": "Achieved model TFLOP/s (learner + self-play)",
    "mfu": "Model FLOP/s utilization: achieved / peak bf16",
    "buffer_fill": "Replay buffer occupancy fraction",
    "buffer_size": "Replay buffer size, experiences",
    "transfer_h2d_ms": "Host->device staging time this tick, ms",
    "transfer_d2h_ms": "Device->host fetch time this tick, ms",
    "compile_cache_hit_rate": "AOT executable cache hit rate so far",
    "mem_bytes_in_use": "Device memory in use across local devices, bytes",
    "mem_peak_bytes_in_use": "Run-wide peak device memory in use, bytes",
    "mem_bytes_limit": "Device memory limit across local devices, bytes",
    "mem_utilization": "Device memory in use / limit",
    "step": "Learner global step",
    # Policy-service SLO gauges (serving/service.py serve ticks).
    "serve_sessions": "Live serving sessions occupying slots",
    "serve_queue_depth": "Move requests waiting for the next dispatch",
    "serve_requests_per_sec": "Served move requests per second",
    "serve_move_latency_ms_p50": "Per-move serve latency p50 this window, ms",
    "serve_move_latency_ms_p95": "Per-move serve latency p95 this window, ms",
    "serve_queue_wait_ms_p95": "Queue wait p95 this window, ms",
    "serve_batch_fill": "Real sessions per dispatch / slot count",
    "serve_weight_reloads": "Hot weight reloads served so far",
    # Bucket-ladder micro-batcher gauges (serving/buckets.py).
    "serve_bucket": "Current serve-shape ladder rung (slot count)",
    "serve_fill": "Latest dispatch wave fill (drives rung walking)",
    "serve_rung_switches": "Ladder rung switches since startup",
    # Device-telemetry plane gauges (telemetry/device_stats.py): the
    # loop mirrors the latest stat-pack fold onto its util records.
    "root_visit_entropy": "Mean MCTS root visit entropy, nats (stat-pack)",
    "tree_occupancy": "Mean search tree slot occupancy fraction (stat-pack)",
    "beacons_armed": "1 when progress beacons are armed in this process",
    # The JAX package's roofline plane names it; the help text stays the
    # JAX one. On the port a dispatch is in flight from before its
    # launches to after its fetch, so this is not the card's idle share
    # (`perf.UtilizationMeter.tick`).
    "chip_idle_fraction": "Fraction of the tick window with no dispatch in flight",
}


def write_prometheus_textfile(
    path: Path | str, record: dict, run_name: str = ""
) -> bool:
    """Render one utilization record as Prometheus textfile gauges.

    Atomic (tmp + replace) so a scraper never reads a half-written
    exposition; numeric fields only, prefixed `alphatriangle_`.
    """
    path = Path(path)
    label = f'{{run="{run_name}"}}' if run_name else ""
    lines = []
    for key, help_text in _PROM_HELP.items():
        value = record.get(key)
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        lines.append(f"# HELP alphatriangle_{key} {help_text}")
        lines.append(f"# TYPE alphatriangle_{key} gauge")
        lines.append(f"alphatriangle_{key}{label} {value}")
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text("\n".join(lines) + "\n")
        tmp.replace(path)
        return True
    except OSError:
        logger.exception("prometheus textfile write to %s failed", path)
        return False


def tick_record(step: int, means: dict, now: "float | None" = None) -> dict:
    """The ledger line for one processed metric batch."""
    return {
        "kind": "tick",
        "step": step,
        "time": time.time() if now is None else now,
        "means": means,
    }
