"""Build the CUDA C++ kernels at first use and load them with ctypes.

Each source under `megatron_llm_tpu_torch/csrc/` is compiled by `nvcc`
for sm_90a into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds) under `build/` at the repository root.
The library's file name carries a hash of its source, so an edited
source is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    # PyTorch's own lookup: $CUDA_HOME / $CUDA_PATH, nvcc on PATH, then
    # the toolkit's default install prefix
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def start_build(source: str):
    """Start `nvcc` on one source; returns (Popen or None, library path).
    None means the library is already built."""
    out = library_path(source)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp_path = tmp
    return proc, out


def finish_build(proc, out: Path) -> Path:
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{out.name}:\n{log}")
    os.replace(proc.tmp_path, out)
    return out


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, building it if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(finish_build(*start_build(source))))
            _loaded[source] = lib
        return lib
