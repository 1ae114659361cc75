"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each source under `csrc/` exports plain C functions, so it compiles with
`nvcc` alone (no PyTorch headers) in a few seconds, for `sm_90a`, into
`_build/` at first use. The library's file name carries a hash of its
source, so an edited source is rebuilt and a stale library is never loaded.

`CudaKernel` owns one library and its launch count: a wrapper adds one to
`launches` right after each launch and nowhere else, so a run can prove
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class CudaKernel:
    """Builds (once per source content), loads and binds one CUDA source.

    Subclasses name `source` (a file in `csrc/`) and bind their C
    functions' argument types in `_bind`.
    """

    source: str = ""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def _bind(self, lib: ctypes.CDLL) -> None:
        raise NotImplementedError

    def build(self) -> ctypes.CDLL:
        """Compile the source if its library is absent, load and bind it."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            src = CSRC / self.source
            digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
            lib_path = BUILD_DIR / f"lib{src.stem}_{digest}.so"
            if not lib_path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                      capture_output=True, text=True)
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src}:\n{self.build_log}")
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(str(lib_path))
            self._bind(lib)
            self._lib = lib
            return lib
