"""The datasets' index builders (port of data/helpers.py): the GPT
sample index and blend index, BERT's sentence-pair map
(`build_mapping`) and ICT's sentence-block map (`build_blocks_mapping`).

`data/csrc/helpers.cpp` is compiled by g++ at first use into
`build/libhelpers-<hash>.so` at the repository root, the hash covering
the source and the flags (as `ops/_build.py` does for nvcc), and loaded
with ctypes. A build that fails raises: the dataset path has no numpy
fallback. `build_sample_idx_np` and `build_blending_indices_np` are the
plain numpy versions the tests hold the C++ against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

from megatron_llm_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "csrc" / "helpers.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update("\0".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libhelpers-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{out.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The loaded helpers library, built first if this checkout has not
    built it."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.build_sample_idx.argtypes = [
                i32p, i32p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
                i32p]
            lib.build_sample_idx.restype = None
            lib.build_blending_indices.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
                ctypes.c_int64]
            lib.build_blending_indices.restype = None
            lib.build_mapping.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, i32p,
                ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32,
                ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int64)]
            lib.build_mapping.restype = ctypes.c_int64
            lib.build_blocks_mapping.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, i32p, i32p,
                ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int64)]
            lib.build_blocks_mapping.restype = ctypes.c_int64
            _lib = lib
        return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def build_sample_idx(sizes: np.ndarray, doc_idx: np.ndarray,
                     seq_length: int, num_epochs: int,
                     tokens_per_epoch: int) -> np.ndarray:
    """(num_samples + 1, 2) int32 rows of (doc_idx index, offset in that
    document): sample i spans row i to row i + 1, inclusive."""
    sizes = np.ascontiguousarray(sizes, np.int32)
    doc_idx = np.ascontiguousarray(doc_idx, np.int32)
    num_samples = (num_epochs * tokens_per_epoch - 1) // seq_length
    out = np.zeros((num_samples + 1, 2), np.int32)
    load().build_sample_idx(_ptr(sizes, ctypes.c_int32),
                            _ptr(doc_idx, ctypes.c_int32), seq_length,
                            num_epochs, tokens_per_epoch,
                            _ptr(out, ctypes.c_int32))
    return out


def build_sample_idx_np(sizes, doc_idx, seq_length: int, num_epochs: int,
                        tokens_per_epoch: int) -> np.ndarray:
    """The plain version of `build_sample_idx`."""
    num_samples = (num_epochs * tokens_per_epoch - 1) // seq_length
    out = np.zeros((num_samples + 1, 2), np.int32)
    doc_idx_index = 0
    doc_offset = 0
    for s in range(1, num_samples + 1):
        remaining = seq_length + 1
        while remaining != 0:
            doc_length = int(sizes[doc_idx[doc_idx_index]]) - doc_offset
            remaining -= doc_length
            if remaining <= 0:
                # the sample ends inside this document; the next one
                # starts on its last token again
                doc_offset += remaining + doc_length - 1
                remaining = 0
            else:
                doc_idx_index += 1
                doc_offset = 0
        out[s] = doc_idx_index, doc_offset
    return out


def build_blending_indices(weights: np.ndarray, size: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(dataset_index uint8[size], dataset_sample_index int64[size]): the
    greedy interleave that keeps each dataset's share closest to its
    weight."""
    weights = np.ascontiguousarray(weights, np.float64)
    dataset_index = np.zeros(size, np.uint8)
    dataset_sample_index = np.zeros(size, np.int64)
    load().build_blending_indices(
        _ptr(dataset_index, ctypes.c_uint8),
        _ptr(dataset_sample_index, ctypes.c_int64),
        _ptr(weights, ctypes.c_double), len(weights), size)
    return dataset_index, dataset_sample_index


def build_blending_indices_np(weights, size: int
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of `build_blending_indices`."""
    weights = np.asarray(weights, np.float64)
    dataset_index = np.zeros(size, np.uint8)
    dataset_sample_index = np.zeros(size, np.int64)
    current = np.zeros(len(weights), np.int64)
    for i in range(size):
        err = weights * max(float(i), 1.0) - current
        best = int(np.argmax(err))
        dataset_index[i] = best
        dataset_sample_index[i] = current[best]
        current[best] += 1
    return dataset_index, dataset_sample_index


def build_mapping(docs: np.ndarray, sizes: np.ndarray, num_epochs: int,
                  max_num_samples: int, max_seq_length: int,
                  short_seq_prob: float, seed: int,
                  min_num_sent: int = 2) -> np.ndarray:
    """(num_samples, 3) int64 rows of (start sentence, end sentence,
    target length) for BERT's sentence-pair samples, shuffled: `docs` the
    (n_docs + 1,) sentence offsets of the documents, `sizes` the
    sentences' token counts. Two calls into the library: count, then
    fill and shuffle. Its draws are std::mt19937's, so the map is the
    JAX package's (and the reference's) bit for bit."""
    docs = np.ascontiguousarray(docs, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int32)
    lib = load()
    args = (_ptr(docs, ctypes.c_int64), len(docs),
            _ptr(sizes, ctypes.c_int32), num_epochs, max_num_samples,
            max_seq_length, short_seq_prob, seed, min_num_sent)
    n = lib.build_mapping(*args, None)
    out = np.zeros((n, 3), np.int64)
    lib.build_mapping(*args, _ptr(out, ctypes.c_int64))
    return out


def build_blocks_mapping(docs: np.ndarray, sizes: np.ndarray,
                         titles_sizes: np.ndarray, num_epochs: int,
                         max_num_samples: int, max_seq_length: int,
                         seed: int, use_one_sent_blocks: bool = False
                         ) -> np.ndarray:
    """(num_samples, 4) int64 rows of (start sentence, end sentence,
    document, block id) for ICT's evidence blocks, shuffled: `docs` and
    `sizes` as for `build_mapping`, `titles_sizes` the (n_docs,) token
    counts of the documents' titles. A block needs two sentences, or
    one under `use_one_sent_blocks`. Two calls into the library: count,
    then fill and shuffle; the map is the JAX package's bit for bit."""
    docs = np.ascontiguousarray(docs, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int32)
    titles_sizes = np.ascontiguousarray(titles_sizes, np.int32)
    lib = load()
    args = (_ptr(docs, ctypes.c_int64), len(docs),
            _ptr(sizes, ctypes.c_int32), _ptr(titles_sizes, ctypes.c_int32),
            num_epochs, max_num_samples, max_seq_length, seed,
            int(use_one_sent_blocks))
    n = lib.build_blocks_mapping(*args, None)
    out = np.zeros((n, 4), np.int64)
    lib.build_blocks_mapping(*args, _ptr(out, ctypes.c_int64))
    return out
