"""Profiling: counterpart of `alphatriangle_tpu/profiling.py`, with
`torch.profiler` in the place of `jax.profiler`.

- `PhaseTimers`: wall-clock seconds per named phase of the training
  loop (rollout, sample, train, megastep, checkpoint, ...), kept for
  the whole run, exported as `Profile/<phase>_ms` metrics each iteration
  and dumped to `phase_timers.json`. Thread-safe: producer threads time
  their phases concurrently.
- `ProfileSession`: the timers plus a bounded trace window over loop
  iterations [trace_start, trace_stop): a `torch.profiler.profile` of
  the host (and, where CUDA is available, the card's kernels, copies
  and sets on every stream), exported as a Chrome trace
  (`<host>_<pid>.<ms>.pt.trace.json`) into the run's `profile_data/`.
  The window opens and closes on the thread that calls `on_iteration`
  (the loop's main thread); `close()` stops a window the run ended
  inside. While the session is enabled each phase is also a
  `record_function` label (`phase/<name>`) in the trace.
- `analyze_profile_dir` (`cli analyze`): the phase table from the dump,
  then, for each trace in the directory, `summarize_chrome_trace`: per
  device stream the kernels by summed time with counts and shares, and
  per host thread the CPU ops the same way. Each line (a stream, or one
  thread's events of one category) is summed on its own, and CPU time
  is counted as each op's self time, so a range nested in another is
  not counted twice.
"""

import json
import logging
import os
import socket
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from pathlib import Path

logger = logging.getLogger(__name__)

TRACE_SUFFIX = ".pt.trace.json"
# Chrome-trace categories of the card's work (one line per device and
# stream) and of the host's (one line per thread and category).
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class PhaseTimers:
    """Accumulates wall-clock seconds per named phase, under a lock
    (several producer threads time the same "rollout" phase)."""

    def __init__(self) -> None:
        self._total: dict[str, float] = defaultdict(float)
        self._count: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._total[name] += dt
                self._count[name] += 1

    def metrics(self) -> dict[str, float]:
        """Mean milliseconds per phase, for the stats pipeline."""
        with self._lock:
            totals = dict(self._total)
            counts = dict(self._count)
        return {
            f"Profile/{name}_ms": 1000.0 * totals[name] / counts[name]
            for name in totals
            if counts[name]
        }

    def summary(self) -> dict[str, dict[str, float]]:
        with self._lock:
            totals = dict(self._total)
            counts = dict(self._count)
        return {
            name: {
                "total_seconds": totals[name],
                "count": counts[name],
                "mean_ms": 1000.0 * totals[name] / max(counts[name], 1),
            }
            for name in sorted(totals)
        }

    def dump(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.summary(), indent=2))


class ProfileSession:
    """One run's profiling: the phase timers and a bounded trace window.

    The window covers iterations [trace_start, trace_stop): after the
    first iteration, so first-use costs stay out, and bounded so the
    trace stays a readable size. With a `tracer` (telemetry's
    `SpanTracer`) each phase is also one span there."""

    def __init__(
        self,
        enabled: bool,
        profile_dir: Path,
        trace_start: int = 1,
        trace_stop: int = 3,
        tracer=None,
    ) -> None:
        if trace_stop <= trace_start:
            # A window that never closes would trace the whole run.
            raise ValueError(f"trace_stop={trace_stop} must be > trace_start={trace_start}")
        self.enabled = enabled
        self.profile_dir = Path(profile_dir)
        self.timers = PhaseTimers()
        self.tracer = tracer
        self._trace_start = trace_start
        self._trace_stop = trace_stop
        self._prof = None
        self.trace_path: "Path | None" = None

    @contextmanager
    def phase(self, name: str):
        label = nullcontext()
        if self.enabled:
            from torch.profiler import record_function

            label = record_function(f"phase/{name}")
        t0 = time.time_ns()
        try:
            with self.timers.phase(name), label:
                yield
        finally:
            if self.tracer is not None:
                self.tracer.complete(name, t0, time.time_ns())

    @property
    def tracing(self) -> bool:
        return self._prof is not None

    def on_iteration(self, iteration: int) -> None:
        """Called at the top of each loop iteration, on the loop's thread."""
        if not self.enabled:
            return
        if iteration == self._trace_start and self._prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self.profile_dir.mkdir(parents=True, exist_ok=True)
            logger.info(
                "Profiling: torch.profiler trace of iterations %d-%d into %s.",
                self._trace_start, self._trace_stop - 1, self.profile_dir,
            )
            prof = profile(activities=activities)
            prof.start()
            self._prof = prof
        elif iteration >= self._trace_stop and self._prof is not None:
            self._stop_trace()

    def _stop_trace(self) -> None:
        # Cleared first: a failing stop must not leave the session
        # retrying, and close() must still dump the timers.
        prof, self._prof = self._prof, None
        prof.stop()
        path = self.profile_dir / (
            f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1000)}{TRACE_SUFFIX}"
        )
        prof.export_chrome_trace(str(path))
        self.trace_path = path
        logger.info("Profiling: trace written to %s.", path)

    def close(self) -> None:
        if self._prof is not None:
            try:
                self._stop_trace()
            except Exception:
                logger.exception("torch.profiler stop failed; dumping the phase timers anyway.")
        if self.enabled:
            self.timers.dump(self.profile_dir / "phase_timers.json")


def analyze_profile_dir(profile_dir: str, top: int = 20) -> int:
    """Print the phase table of a profile run and a summary of each of its
    traces (`cli analyze`). 0 when there is a dump or a trace, else 1."""
    root = Path(profile_dir)
    dump = root / "phase_timers.json"
    if dump.exists():
        summary = json.loads(dump.read_text())
        rows = sorted(summary.items(), key=lambda kv: kv[1]["total_seconds"], reverse=True)[:top]
        width = max((len(name) for name, _ in rows), default=5)
        print(f"{'phase':<{width}}  {'total s':>9}  {'count':>7}  {'mean ms':>9}")
        for name, s in rows:
            print(
                f"{name:<{width}}  {s['total_seconds']:>9.2f}  "
                f"{s['count']:>7d}  {s['mean_ms']:>9.2f}"
            )
    else:
        print(f"No phase_timers.json in {root}.")
    traces = sorted(root.glob(f"**/*{TRACE_SUFFIX}"))
    if traces:
        print(f"\n{len(traces)} trace(s):")
        for t in traces[:top]:
            print(f"  {t}")
            print_trace_summary(summarize_chrome_trace(t), top=top)
        print("View with chrome://tracing or https://ui.perfetto.dev.")
    elif not dump.exists():
        return 1
    return 0


def _self_times(events: list) -> list:
    """(name, self microseconds) of each event of one line: its duration
    less the durations of the events nested directly inside it."""
    events = sorted(events, key=lambda e: (e[1], -e[2]))
    out, stack = [], []  # stack of [end, name, self_us]
    for name, ts, dur in events:
        while stack and ts >= stack[-1][0]:
            _, n, selft = stack.pop()
            out.append((n, selft))
        if stack:
            stack[-1][2] -= min(dur, stack[-1][0] - ts)
        stack.append([ts + dur, name, dur])
    out.extend((n, selft) for _, n, selft in stack)
    return out


def summarize_chrome_trace(path) -> list[dict]:
    """A `torch.profiler` Chrome trace, summed per line: one line per
    device and stream (categories `DEVICE_CATEGORIES`), one per host
    thread and category (`HOST_CATEGORIES`). Each line: its `plane`
    ("device <pid>" or "host"), `line` ("stream <tid>" or "thread <tid>
    <category>"), `events`, `total_us` and `ops`, the ops by summed
    (self) time: `{name, total_us, count, share}`, largest first."""
    data = json.loads(Path(path).read_text())
    events = data.get("traceEvents", data) if isinstance(data, dict) else data
    lines: dict = defaultdict(list)
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        try:
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        except (KeyError, TypeError, ValueError):
            continue
        if cat in DEVICE_CATEGORIES:
            key = (f"device {ev.get('pid')}", f"stream {ev.get('tid')}", True)
        elif cat in HOST_CATEGORIES:
            key = ("host", f"thread {ev.get('tid')} {cat}", False)
        else:
            continue
        lines[key].append((str(ev.get("name")), ts, dur))
    out = []
    for (plane, line, device), evs in sorted(lines.items(), key=lambda kv: (not kv[0][2], kv[0][:2])):
        pairs = [(n, d) for n, _, d in evs] if device else _self_times(evs)
        total: dict = defaultdict(float)
        count: dict = defaultdict(int)
        for name, us in pairs:
            total[name] += us
            count[name] += 1
        grand = sum(total.values())
        ops = [
            {"name": n, "total_us": us, "count": count[n], "share": us / grand if grand else 0.0}
            for n, us in sorted(total.items(), key=lambda kv: kv[1], reverse=True)
        ]
        out.append({"plane": plane, "line": line, "events": len(evs), "total_us": grand, "ops": ops})
    return out


def print_trace_summary(lines: list, top: int = 20) -> None:
    for ln in lines:
        print(
            f"\n  {ln['plane']} / {ln['line']}: {ln['events']} events, "
            f"{ln['total_us'] / 1e6:.3f}s summed {'kernel' if ln['plane'] != 'host' else 'self'} time"
        )
        print(f"    {'op':<52} {'total ms':>10} {'count':>8} {'%':>6}")
        for op in ln["ops"][:top]:
            name = op["name"]
            label = name if len(name) <= 52 else name[:49] + "..."
            print(
                f"    {label:<52} {op['total_us'] / 1e3:>10.2f} "
                f"{op['count']:>8d} {100.0 * op['share']:>5.1f}%"
            )
