"""The build cache of the port's hand-written kernels: counterpart of
`alphatriangle_tpu/compile_cache.py`, for what carries over from an
XLA executable cache to kernels compiled by `nvcc`.

The port compiles no program: its hot paths are eager PyTorch over
cuBLAS / cuDNN and the `csrc/` kernels. What is compiled, and cached
across processes, is each kernel's shared library, which
`ops/_cuda.py` builds on first use into `BUILD_DIR`, named by a digest
of its source and flags. This module keeps the JAX cache's accounts of
that cache:

- `stats()`: hits (a kernel whose library this process loaded from
  `BUILD_DIR`) and misses (a kernel `nvcc` built here), each with its
  seconds in `events`; the util records' `compile_hits` /
  `compile_misses` read them (`telemetry/__init__.py`).
- the tracer hook (`set_tracer`): every build or load becomes a
  `compile/<kernel>` span in the run's `trace.json`.
- the per-program memory and cost records (`capture_memory`,
  `capture_cost`): the measured program records of `telemetry/memory.py`
  and the analytic cost records of `telemetry/roofline.py`, registered
  by whatever runs or dispatches a program in this process and drained
  into each run's ledger once (`RunTelemetry`).
- the source and config digests (`source_digest`, `config_digest`),
  which key a record to the code and configs that made it.

There is no executable to serialize and no AOT fallback: a kernel that
does not build raises (`ops/_cuda.py`). A cache built with
`enabled=False` registers no program record (the kernels are built and
counted all the same). Imports no torch.
"""

import hashlib
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent


def _package_source_digest() -> str:
    """Digest of every .py file of the package and every kernel source:
    a record is only reused by the code that produced it."""
    h = hashlib.sha256()
    for pattern in ("*.py", "*.cu"):
        for path in sorted(PACKAGE_DIR.rglob(pattern)):
            h.update(str(path.relative_to(PACKAGE_DIR)).encode())
            try:
                h.update(path.read_bytes())
            except OSError:
                h.update(b"?")
    return h.hexdigest()[:16]


_source_digest_cache: "str | None" = None


def source_digest() -> str:
    global _source_digest_cache
    if _source_digest_cache is None:
        _source_digest_cache = _package_source_digest()
    return _source_digest_cache


def config_digest(*configs) -> str:
    """Fingerprint of the configs that shape a program but not its
    inputs' shapes (simulation counts, loss weights). Config objects
    dump to sorted items; anything else reprs. RUN_NAME is left out: it
    shapes nothing."""
    h = hashlib.sha256()
    for cfg in configs:
        if cfg is None:
            h.update(b"none")
            continue
        dump = getattr(cfg, "model_dump", None)
        if callable(dump):
            d = dump()
            d.pop("RUN_NAME", None)
            h.update(repr(sorted(d.items())).encode())
        else:
            h.update(repr(cfg).encode())
    return h.hexdigest()[:12]


class BuildCache:
    """Process-wide accounts of the kernel build cache (module doc)."""

    def __init__(self, cache_dir: "str | Path | None" = None, enabled: bool = True) -> None:
        if cache_dir is None:
            cache_dir = PACKAGE_DIR / "_build"
        self.cache_dir = Path(cache_dir)
        self.enabled = enabled
        self.tracer = None  # a telemetry SpanTracer, when a run attached one
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        # {"event": "hit" | "miss", "program": kernel, "seconds": s}
        self.events: list = []
        # "name:key" -> record (telemetry/memory.py, telemetry/roofline.py).
        self.memory_records: dict = {}
        self.cost_records: dict = {}

    # --- wiring -----------------------------------------------------------

    def set_tracer(self, tracer) -> None:
        """Attach a run's SpanTracer: every build or load of a kernel
        library becomes a `compile/<kernel>` span in its trace.json."""
        self.tracer = tracer

    def note(self, event: str, kernel: str, seconds: float, begin_ns: "int | None" = None) -> None:
        """One library load ("hit": found in the cache directory) or
        build ("miss": `nvcc` ran here) of `kernel`, and its span."""
        with self._lock:
            if event == "hit":
                self.hits += 1
            else:
                self.misses += 1
            self.events.append({"event": event, "program": kernel, "seconds": round(seconds, 3)})
            tracer = self.tracer
        if tracer is not None:
            end = time.time_ns()
            begin = begin_ns if begin_ns is not None else end - int(seconds * 1e9)
            tracer.complete(f"compile/{kernel}", begin, end, event="load" if event == "hit" else "build")

    # --- program records ----------------------------------------------------

    def _register(self, table: dict, record: "dict | None") -> "dict | None":
        if not self.enabled or not isinstance(record, dict):
            return None
        rid = f"{record.get('program')}:{record.get('key', '')}"
        with self._lock:
            return table.setdefault(rid, record)

    def capture_memory(self, record: "dict | None") -> "dict | None":
        """Register a program memory record (the first of its program and
        key wins); returns the registered one."""
        return self._register(self.memory_records, record)

    def capture_cost(self, record: "dict | None") -> "dict | None":
        """Register a program cost record (the first of its program and
        key wins); returns the registered one."""
        return self._register(self.cost_records, record)

    def cost_record_for(self, program: str, key: str = "") -> "dict | None":
        with self._lock:
            return self.cost_records.get(f"{program}:{key}")

    def memory_summary(self) -> list:
        with self._lock:
            return list(self.memory_records.values())

    def cost_summary(self) -> list:
        with self._lock:
            return list(self.cost_records.values())

    # --- reporting --------------------------------------------------------

    def stats(self) -> dict:
        """The JAX cache's `compile_cache` block for the kernel builds."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "dir": str(self.cache_dir),
                "hits": self.hits,
                "misses": self.misses,
                "events": list(self.events),
            }


_global_cache: "BuildCache | None" = None
_global_lock = threading.Lock()


def get_build_cache() -> BuildCache:
    """The process-wide build cache every kernel reports to."""
    global _global_cache
    with _global_lock:
        if _global_cache is None:
            _global_cache = BuildCache()
        return _global_cache
