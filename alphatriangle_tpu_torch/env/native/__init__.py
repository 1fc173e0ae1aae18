"""The native host engine (`engine.cpp`) over ctypes: counterpart of
`alphatriangle_tpu/env/native/`.

The port keeps its own copy of `engine.cpp`. It is compiled with g++ at
first use into the package's `_build/` directory (named by a digest of
the source and the flags, never beside the source), and plays on the
bitboard tables the port's `TriangleEnv` builds (`_tables_np`), so
there is one source of the rules. This is a host engine for interactive
play and tests, not a card kernel.

`native_available()` probes the build; `native_build_error()` says why
it failed (no g++, a read-only tree, ...), and callers then use the
tensor engine.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).parent / "engine.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_build_error: "str | None" = None

_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"at_engine-{digest}.so"


def _build() -> "ctypes.CDLL | None":
    global _build_error
    lib = library_path()
    if lib.exists():
        return ctypes.CDLL(str(lib))
    # Built under a name of this process's, then moved into place, so two
    # processes building at once never load a half-written library.
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as exc:
        _build_error = f"g++ unavailable: {exc}"
        logger.warning("Native engine build skipped (%s)", _build_error)
        return None
    if proc.returncode != 0:
        _build_error = proc.stderr.strip()[-500:]
        logger.warning("Native engine build failed: %s", _build_error)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.at_create.restype = ctypes.c_void_p
    lib.at_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        _u32p, _u32p,
    ]
    lib.at_destroy.argtypes = [ctypes.c_void_p]
    lib.at_valid_mask.argtypes = [ctypes.c_void_p, ctypes.c_int, _u32p, _i32p, _u8p, _u8p]
    lib.at_step.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        _u32p, _i8p, _i32p, _i8p, _i32p, _u64p,
        _f32p, _u8p, _f32p, _i32p, _i32p,
    ]
    return lib


def get_lib() -> "ctypes.CDLL | None":
    """The built and bound library, or None when it cannot be built."""
    global _lib
    with _lock:
        if _lib is None and _build_error is None:
            lib = _build()
            if lib is not None:
                _lib = _bind(lib)
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def native_build_error() -> "str | None":
    return _build_error


class NativeBatch:
    """Mutable struct-of-arrays state of N native games."""

    def __init__(self, engine: "NativeTriangleEnv", n: int, seed: int = 0):
        e = engine
        self.n = n
        self.occupied = np.zeros((n, e.num_words), np.uint32)
        self.color = np.full((n, e.cells), -1, np.int8)
        self.shape_idx = np.full((n, e.num_slots), -1, np.int32)
        self.shape_color = np.zeros((n, e.num_slots), np.int8)
        self.rng = np.random.default_rng(seed).integers(1, 2**63, n, dtype=np.uint64)
        self.rewards = np.zeros(n, np.float32)
        self.done = np.zeros(n, np.uint8)
        self.score = np.zeros(n, np.float32)
        self.step_count = np.zeros(n, np.int32)
        self.last_cleared = np.zeros(n, np.int32)


class NativeTriangleEnv:
    """Batched host engine on the port engine's bitboard tables. Mirrors
    `TriangleEnv.step` / `valid_action_mask` on NumPy arrays; its refills
    draw from a host xorshift stream (equally distributed, not the
    tensor engines' threefry draws)."""

    def __init__(self, env):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native engine unavailable: {native_build_error()}")
        self._lib = lib
        cfg = env.cfg
        tables = env._tables_np
        self.cfg = cfg
        self.rows, self.cols = cfg.ROWS, cfg.COLS
        self.cells = env.cells
        self.num_words = env.num_words
        self.num_slots = cfg.NUM_SHAPE_SLOTS
        self.action_dim = cfg.action_dim
        self.n_shapes = env.bank.n_shapes
        self._fp = np.ascontiguousarray(tables.footprint_ext, dtype=np.uint32)
        self._lines = np.ascontiguousarray(tables.line_words, dtype=np.uint32)
        self._handle = lib.at_create(
            self.rows, self.cols, self.num_slots, self.n_shapes,
            self.num_words, self._lines.shape[0], cfg.NUM_COLORS,
            cfg.REWARD_PER_PLACED_TRIANGLE, cfg.REWARD_PER_CLEARED_TRIANGLE,
            cfg.PENALTY_GAME_OVER,
            self._fp.reshape(-1), self._lines.reshape(-1),
        )

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.at_destroy(handle)
            self._handle = None

    def new_batch(self, n: int, seed: int = 0) -> NativeBatch:
        """N fresh games with freshly drawn hands."""
        batch = NativeBatch(self, n, seed)
        self.refill_hands(batch)
        return batch

    def refill_hands(self, batch: NativeBatch, seed: int = 0) -> None:
        """A fresh full hand for every game (host RNG; refills within a
        game happen inside the engine)."""
        rng = np.random.default_rng((seed, batch.n))
        batch.shape_idx[:] = rng.integers(0, self.n_shapes, batch.shape_idx.shape, dtype=np.int32)
        batch.shape_color[:] = rng.integers(
            0, self.cfg.NUM_COLORS, batch.shape_color.shape
        ).astype(np.int8)

    def valid_mask(self, batch: NativeBatch) -> np.ndarray:
        out = np.zeros((batch.n, self.action_dim), np.uint8)
        self._lib.at_valid_mask(
            self._handle, batch.n,
            np.ascontiguousarray(batch.occupied),
            np.ascontiguousarray(batch.shape_idx),
            np.ascontiguousarray(batch.done),
            out,
        )
        return out.astype(bool)

    def step(self, batch: NativeBatch, actions: np.ndarray, refill: bool = True) -> tuple:
        """Advance every game by one action, in place. Returns (rewards,
        done), views into the batch."""
        self._lib.at_step(
            self._handle, batch.n, int(refill),
            batch.occupied, batch.color.reshape(-1),
            batch.shape_idx, batch.shape_color.reshape(-1),
            np.ascontiguousarray(actions, dtype=np.int32), batch.rng,
            batch.rewards, batch.done, batch.score, batch.step_count,
            batch.last_cleared,
        )
        return batch.rewards, batch.done


__all__ = [
    "NativeBatch",
    "NativeTriangleEnv",
    "get_lib",
    "library_path",
    "native_available",
    "native_build_error",
]
