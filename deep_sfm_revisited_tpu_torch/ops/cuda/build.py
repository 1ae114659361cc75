"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each source under `csrc/` exports plain C functions, so it compiles with
`nvcc` alone (no PyTorch headers) in a few seconds, for `sm_90a`, into
`_build/` at first use. The library's file name carries a hash of its
source and of the headers under `csrc/` (`*.cuh`, on the include path of
every build), so an edited source or header is rebuilt and a stale library
is never loaded.

`CudaKernel` owns one library and its launch count: a wrapper adds one to
`launches` right after each launch and nowhere else, so a run can prove
that its main path went through the kernel.

`TorchOps` builds a source that registers PyTorch operators
(`TORCH_LIBRARY`) around the plain C launchers of one or more `CudaKernel`
libraries:
host code compiled by nvcc against `torch.utils.cpp_extension`'s include
and library paths (no ninja, no pybind11), linked to those libraries, into
`_build/` at first use, and loaded with `torch.ops.load_library`.
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{CSRC}"]


def source_digest(src: Path) -> str:
    """Hash of a source and of every header it may include from `csrc/`."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:12]


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
        self.path: Path | None = None
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
            lib_path = BUILD_DIR / f"lib{src.stem}_{source_digest(src)}.so"
            if not lib_path.exists():
                self.build_log = _compile([_nvcc(), *NVCC_FLAGS, str(src)], lib_path, src)
            lib = ctypes.CDLL(str(lib_path))
            self._bind(lib)
            self.path = lib_path
            self._lib = lib
            return lib


def _compile(cmd: list, out: Path, src: Path) -> str:
    """Run nvcc `cmd` (which writes `-o <tmp>`) and move the result to `out`;
    returns the compiler's output, raises with it on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    os.replace(tmp, out)
    return log


class TorchOps:
    """Builds (once per source, kernel libraries and torch version), links
    and loads one operator source; `build()` returns `torch.ops.<namespace>`."""

    def __init__(self, source: str, kernels: CudaKernel | tuple[CudaKernel, ...],
                 namespace: str):
        self.source, self.namespace = source, namespace
        self.kernels = kernels if isinstance(kernels, tuple) else (kernels,)
        self.build_log = ""
        self._ops = None
        self._lock = threading.Lock()

    def build(self):
        with self._lock:
            if self._ops is not None:
                return self._ops
            import torch
            from torch.utils import cpp_extension

            for kernel in self.kernels:
                kernel.build()
            src = CSRC / self.source
            key = (src.read_bytes() + "".join(k.path.name for k in self.kernels).encode()
                   + torch.__version__.encode())
            lib_path = BUILD_DIR / f"lib{src.stem}_{hashlib.sha256(key).hexdigest()[:12]}.so"
            if not lib_path.exists():
                # torch's own libraries are loaded with torch, so the
                # library finds them by name without an rpath
                lib_dirs = cpp_extension.library_paths()
                abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
                self.build_log = _compile(
                    [_nvcc(), "-std=c++20", "-O2", "-shared", "-Xcompiler", "-fPIC",
                     f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
                     *(f"-I{d}" for d in cpp_extension.include_paths()),
                     str(src), *(str(k.path) for k in self.kernels),
                     *(f"-L{d}" for d in lib_dirs), "-lc10", "-ltorch_cpu"], lib_path, src)
            torch.ops.load_library(str(lib_path))
            self._ops = getattr(torch.ops, self.namespace)
            return self._ops
