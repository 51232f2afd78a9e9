"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one source under `csrc/` with a plain C entry point.  At first
use on the card, `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`
compiles it into its own library in the git-ignored `_build/` (again only
when the source is newer than the library), and ctypes binds the entry
point.  Nothing here runs when a module is imported: the CPU tests import
every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

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


class CudaKernel:
    """One `csrc/<name>.cu` source, its library and its bound entry point.

    `symbol` is the C launcher's name and `argtypes` its ctypes signature
    (`c_void_p` for every pointer and the stream); the launcher returns
    cudaGetLastError() after the launch as an int."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        stem = os.path.splitext(source)[0]
        self.source = os.path.join(CSRC_DIR, source)
        self.lib_path = os.path.join(BUILD_DIR, f"lib{stem}.so")
        self.symbol = symbol
        self.argtypes = argtypes
        # nvcc's output of the last build (ptxas register / spill report)
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    def build(self) -> str:
        """Compile the library if it is missing or older than its source;
        -> its path.  Raises if nvcc fails."""
        if os.path.exists(self.lib_path) and \
                os.path.getmtime(self.lib_path) >= os.path.getmtime(self.source):
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
