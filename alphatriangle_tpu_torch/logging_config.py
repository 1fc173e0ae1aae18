"""Root logging setup: counterpart of `alphatriangle_tpu/logging_config.py`.

A `▲ [LEVEL] name: msg` console formatter on stderr, colored per level
when stderr is a terminal; the noisy third-party loggers clamped to
WARNING.
"""

import logging
import sys

RESET = "\x1b[0m"
COLORS = {
    logging.DEBUG: "\x1b[36m",  # cyan
    logging.INFO: "\x1b[32m",  # green
    logging.WARNING: "\x1b[33m",  # yellow
    logging.ERROR: "\x1b[31m",  # red
    logging.CRITICAL: "\x1b[41m",  # red background
}


class TriangleFormatter(logging.Formatter):
    """`▲ [LEVEL] name: msg` with per-level ANSI color."""

    def format(self, record: logging.LogRecord) -> str:
        base = f"▲ [{record.levelname}] {record.name}: {record.getMessage()}"
        if record.exc_info:
            base += "\n" + self.formatException(record.exc_info)
        if sys.stderr.isatty():
            return f"{COLORS.get(record.levelno, '')}{base}{RESET}"
        return base


class _StderrHandler(logging.StreamHandler):
    """A console handler on whatever `sys.stderr` is at each record, so a
    caller that swaps the stream (a test's capture) is followed."""

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value) -> None:
        pass


def setup_logging(level: "int | str" = logging.INFO) -> None:
    """Configure the root logger (idempotent: replaces its handlers)."""
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.INFO)
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)
    console = _StderrHandler()
    console.setFormatter(TriangleFormatter())
    root.addHandler(console)
    for noisy in ("torch", "numba", "matplotlib", "PIL"):
        logging.getLogger(noisy).setLevel(logging.WARNING)
