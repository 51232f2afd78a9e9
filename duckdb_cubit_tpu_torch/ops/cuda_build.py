"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one source under `csrc/` with a plain C entry point (device
helpers the kernels share sit in `csrc/*.cuh`).  At first use on the card,
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared` compiles it into
its own library in the git-ignored `_build/` (again only when the source or
a shared header is newer than the library), and ctypes binds the entry
point.  Nothing here runs when a module is imported: the CPU tests import
every module on a machine without nvcc.

Each kernel has a short name (`k1`, `k2`, ...): `CudaKernel.launch` counts
its launches in the profiler's counter table as `<name>_launches`, and
every kernel made is listed in `KERNELS`.  A plain torch body never reaches
`launch`, so it counts nothing.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from ..exec import profiler as PROF

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build the port's kernels")
    return found


# every CudaKernel made, in the order made
KERNELS: list["CudaKernel"] = []


class CudaKernel:
    """One `csrc/<source>` file, its library and its bound entry point.

    `name` is the kernel's short name (`k1`): its launches are the counter
    `<name>_launches`.  `symbol` is the C launcher's name and `argtypes` its
    ctypes signature (`c_void_p` for every pointer and the stream); the
    launcher returns cudaGetLastError() after the launch as an int."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.stem = os.path.splitext(source)[0]
        self.counter = f"{name}_launches"
        self.source = os.path.join(CSRC_DIR, source)
        self.lib_path = os.path.join(BUILD_DIR, f"lib{self.stem}.so")
        self.symbol = symbol
        self.argtypes = argtypes
        # nvcc's output of the last build (ptxas register / spill report)
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()
        PROF.declare(self.counter)
        KERNELS.append(self)

    def build(self) -> str:
        """Compile the library if it is missing or older than its source or
        a shared header; -> its path.  Raises if nvcc fails."""
        headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
        newest = max(os.path.getmtime(p) for p in [self.source, *headers])
        if os.path.exists(self.lib_path) and \
                os.path.getmtime(self.lib_path) >= newest:
            return self.lib_path
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                   self.source], capture_output=True,
                                  text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source} "
                                   f"({proc.returncode}):\n{self.build_log}")
            os.replace(tmp, self.lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return self.lib_path

    def function(self):
        """The bound C launcher (building the library first if needed)."""
        with self._lock:
            if self._fn is None:
                fn = getattr(ctypes.CDLL(self.build()), self.symbol)
                fn.restype = ctypes.c_int
                fn.argtypes = self.argtypes
                self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Call the launcher with `args` and the current stream of `device`
        (its last argument); raise if the launch was refused, else count it.
        The device context is entered only when `device` is not the current
        one."""
        fn = self.function()
        index = _index(device)
        if index == torch.cuda.current_device():
            rc = fn(*args, _raw_stream(index))
        else:
            with torch.cuda.device(index):
                rc = fn(*args, _raw_stream(index))
        if rc != 0:
            raise RuntimeError(f"{self.symbol} failed: CUDA error {rc}")
        PROF.count(self.counter)


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _raw_stream(index: int) -> int:
    """The handle of the current stream of card `index`: one C call per
    launch, so a caller's `torch.cuda.stream(...)` context is honoured
    (a handle cached per device would not see it)."""
    return torch._C._cuda_getCurrentRawStream(index)


# (card, stream handle) -> the kernels' (2,) int64 scratch on that stream:
# zero when made, and each launch that uses it leaves it zero again, so
# launches on one stream (which run in turn) share it and no launch needs a
# memset or a fill first
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def stream_scratch(device: torch.device) -> torch.Tensor:
    """The self-resetting scratch of the current stream of `device` (K3 and
    K4 use both words, K5a and K5b the first)."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        scratch = _SCRATCH[key] = torch.zeros(2, dtype=torch.int64,
                                              device=device)
    return scratch


# card index -> multiprocessor count: a fixed property, asked once a card
_SM_COUNTS: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The card's multiprocessor count (launchers size their grids by it)."""
    index = _index(device)
    count = _SM_COUNTS.get(index)
    if count is None:
        count = _SM_COUNTS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return count
