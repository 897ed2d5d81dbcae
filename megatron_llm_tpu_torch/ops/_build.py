"""Build the CUDA C++ kernels at first use and load them with ctypes.

Each source under `megatron_llm_tpu_torch/csrc/` is compiled by `nvcc`
for sm_90a into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds) under `build/` at the repository root.
The library's file name carries a hash of its source, of every
`csrc/*.cuh` header the source includes (directly or through another
header) and of the nvcc flags, so an edited source or header is rebuilt
and an unchanged one is loaded as it is. nvcc's output, with ptxas's
registers, shared memory and spills for each kernel (`-Xptxas -v`), is
kept beside the library as `<library>.log`.

Ranks that start together (torchrun, one process per rank) build each
library once: the build runs under an `fcntl` lock on a file in the
build directory, and a process that waited for it finds the library
built and loads it. The kernel holds the lock, so a process that dies
mid-build leaves no stale lock behind.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+\.cuh)"', re.M)

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


def included_headers(src: Path, csrc: Path = CSRC) -> list:
    """The `csrc/*.cuh` headers `src` includes, directly or through
    another header, sorted."""
    found, todo = set(), [src]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_text()):
            header = csrc / name
            if header.is_file() and header not in found:
                found.add(header)
                todo.append(header)
    return sorted(found)


def library_path(source: str, csrc: Path = CSRC,
                 build_dir: Path = BUILD_DIR) -> Path:
    src = csrc / source
    h = hashlib.sha256()
    for f in (src, *included_headers(src, csrc)):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return build_dir / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_log(source: str):
    """nvcc's output of the library `source` loads, or None where it was
    not built by this checkout."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else None


def start_build(source: str, csrc: Path = CSRC, build_dir: Path = BUILD_DIR,
                nvcc=None):
    """Start `nvcc` on one source; returns (Popen or None, library path).
    None means the library is already built."""
    out = library_path(source, csrc, build_dir)
    if out.exists():
        return None, out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc or nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(csrc / source)]
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
    out.with_suffix(".log").write_text(log)
    os.replace(proc.tmp_path, out)
    return out


@contextlib.contextmanager
def build_lock(name: str, build_dir: Path = BUILD_DIR):
    """Hold the build directory's lock for `name` across processes."""
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / f".{name}.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_library(source: str, csrc: Path = CSRC,
                  build_dir: Path = BUILD_DIR, nvcc=None) -> Path:
    """The library of `csrc/<source>`, built by this process unless it is
    built already or another process builds it first."""
    with build_lock(Path(source).stem, build_dir):
        return finish_build(*start_build(source, csrc, build_dir, nvcc))


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, building it if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(source)))
            _loaded[source] = lib
        return lib
