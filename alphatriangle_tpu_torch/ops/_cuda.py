"""Build and bind the hand-written CUDA kernels in `csrc/`.

Each kernel source has a plain C interface (`extern "C"` launch function
returning the `cudaError_t` of its launch). On first use, `nvcc` compiles
it for `sm_90a` into a shared library under `alphatriangle_tpu_torch/
_build/`, named by a digest of the source and flags, and `ctypes` loads
it. Nothing is built when a module is imported, and nothing falls back:
a failed build or launch raises.

`CudaKernel.launches` counts successful launches, so a run can show that
its main path went through the kernel. Producer threads launch
concurrently: the count and the first load are under a lock.
`CudaKernel.builds` counts the `nvcc` runs of this process and `loaded`
says whether its library is loaded: a serve replica reports both, and a
weight reload must change neither. Each build (a miss of the build
cache, with its `nvcc` seconds) and each load of a library built before
(a hit) is reported to the process's `compile_cache.BuildCache`, whose
counts the util records carry.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

from ..compile_cache import get_build_cache

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    home = CUDA_HOME or os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = Path(home) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}; the CUDA kernels cannot be built")
    return str(nvcc)


class CudaKernel:
    """One `csrc/` source, its shared library and its launch function."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.builds = 0
        self._lock = threading.Lock()
        self._lib = None
        self._fn = None
        self._err = None

    @property
    def library(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{digest.hexdigest()[:16]}.so"

    @property
    def log(self) -> Path:
        return BUILD_DIR / f"{self.name}.log"

    def start_build(self) -> "subprocess.Popen | None":
        """Start `nvcc` for this kernel unless its library exists; the
        output goes to a temporary file renamed into place by `finish`."""
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        log = open(self.log, "w")
        began = time.time_ns(), time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        proc.tmp, proc.logfile, proc.began = tmp, log, began
        return proc

    def finish(self, proc: "subprocess.Popen | None") -> None:
        if proc is None:
            return
        rc = proc.wait()
        proc.logfile.close()
        if rc != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source.name} (exit {rc}):\n{self.log.read_text()}"
            )
        os.replace(proc.tmp, self.library)
        self.builds += 1
        get_build_cache().note("miss", self.name, time.perf_counter() - proc.began[1], proc.began[0])

    @property
    def loaded(self) -> bool:
        return self._fn is not None

    def load(self):
        """The launch function, building the library first if needed."""
        with self._lock:
            if self._fn is None:
                self._load()
        return self._fn

    def _load(self) -> None:
        began = time.time_ns(), time.perf_counter()
        self.finish(self.start_build())
        self._lib = ctypes.CDLL(str(self.library))
        if self.builds == 0:
            get_build_cache().note("hit", self.name, time.perf_counter() - began[1], began[0])
        fn = getattr(self._lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = getattr(self._lib, f"{self.name}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def function(self, name: str, argtypes: list, restype=ctypes.c_int):
        """Another function of the loaded library (load it first)."""
        fn = getattr(self._lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
        return fn

    def error(self, rc: int) -> str:
        return f"{self._err(rc).decode()} ({rc})"

    def launch(self, *args) -> None:
        """Launch on the given arguments; raise if the launch is refused."""
        rc = self.load()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: {self.error(rc)}")
        with self._lock:
            self.launches += 1


def build_all(kernels) -> float:
    """Build every kernel's library at once (one `nvcc` each, all
    started together); returns the wall seconds it took."""
    t0 = time.perf_counter()
    procs = [(k, k.start_build()) for k in kernels]
    for k, proc in procs:
        k.finish(proc)
    for k in kernels:
        k.load()
    return time.perf_counter() - t0


def stream_ptr(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


def check_cuda(name: str, tensor, dtype, shape=None) -> None:
    """Raise unless `tensor` is a contiguous CUDA tensor of `dtype`
    (and `shape`, when given): what a kernel takes."""
    if tensor.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {tensor.device}")
    if tensor.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {tensor.dtype}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(tensor.shape)}")
