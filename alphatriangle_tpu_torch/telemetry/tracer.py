"""Host-side span tracer: counterpart of `alphatriangle_tpu/telemetry/
tracer.py`'s `SpanTracer`, writing the same Chrome trace format.

Named wall-clock spans (a fleet replica records one `replica/episode`
span per served game) are ring-buffered in memory, an O(1) append under
a lock from any thread, and exported as Chrome trace events to
`trace.json` in the run directory when the run closes, or when a stall
or a wedge flushes them. Load it in chrome://tracing or
https://ui.perfetto.dev.
"""

import json
import logging
import os
import threading
import time
from collections import deque
from pathlib import Path

logger = logging.getLogger(__name__)

# A span record: (name, begin_ns, duration_ns, thread_id, thread_name,
# args-or-None). `kind` "X" (complete span) or "i" (instant event,
# duration 0) per the Chrome trace event format.
_COMPLETE = "X"
_INSTANT = "i"


class SpanTracer:
    """Thread-aware ring buffer of named wall-clock spans.

    Ingestion is a timestamp read plus one deque append under a lock —
    safe from any thread (rollout producers, the learner/consumer, the
    watchdog) and cheap enough to run always-on. The ring bounds memory:
    a multi-day run keeps the most recent `capacity` spans, which is
    exactly the window that matters when diagnosing where it stalled.
    """

    def __init__(self, capacity: int = 65536) -> None:
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=max(1, capacity))
        self.recorded = 0  # total ever recorded (ring may have evicted)

    # --- ingestion (any thread, O(1)) ---------------------------------

    def complete(
        self, name: str, begin_ns: int, end_ns: int, **args
    ) -> None:
        """Record a complete span from explicit wall timestamps — for
        spans whose begin was captured earlier than the code that
        finishes them (e.g. a serve replica records the whole episode
        span at finish, begin captured at request arrival). Duration is
        clamped non-negative so a torn clock can't corrupt the trace."""
        thread = threading.current_thread()
        with self._lock:
            self._spans.append(
                (_COMPLETE, name, int(begin_ns),
                 max(0, int(end_ns) - int(begin_ns)), thread.ident,
                 thread.name, args or None)
            )
            self.recorded += 1

    def instant(self, name: str, **args) -> None:
        """Record a zero-duration marker (e.g. a watchdog stall)."""
        thread = threading.current_thread()
        with self._lock:
            self._spans.append(
                (_INSTANT, name, time.time_ns(), 0, thread.ident,
                 thread.name, args or None)
            )
            self.recorded += 1

    # --- export / summary ---------------------------------------------

    def _snapshot(self) -> list:
        with self._lock:
            return list(self._spans)

    def export(self, path: Path) -> int:
        """Write the buffered spans as a Chrome trace; returns the event
        count. Atomic (tmp + rename) so a reader never sees a torn file;
        IO failures are logged, never raised (observability is not
        allowed to kill a run)."""
        spans = self._snapshot()
        pid = os.getpid()
        events = []
        thread_names: dict[int, str] = {}
        for kind, name, t0_ns, dur_ns, tid, tname, args in spans:
            thread_names.setdefault(tid, tname)
            ev = {
                "name": name,
                "ph": kind,
                "ts": t0_ns // 1000,  # Chrome traces use microseconds
                "pid": pid,
                "tid": tid,
                "cat": "host",
            }
            if kind == _COMPLETE:
                ev["dur"] = dur_ns // 1000
            else:
                ev["s"] = "g"  # global-scope instant
            if args:
                ev["args"] = args
            events.append(ev)
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": tname},
            }
            for tid, tname in sorted(thread_names.items())
        ]
        payload = {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"recorded": self.recorded, "exported": len(events)},
        }
        try:
            path = Path(path)
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".json.tmp")
            tmp.write_text(json.dumps(payload))
            tmp.replace(path)
        except OSError:
            logger.exception("span trace export to %s failed", path)
            return 0
        if self.recorded > len(spans):
            logger.info(
                "span trace: ring kept the newest %d of %d spans.",
                len(spans),
                self.recorded,
            )
        return len(events)
