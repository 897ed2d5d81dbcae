"""Memory-mapped token datasets (port of data/indexed_dataset.py).

The same file format, byte for byte, as the JAX package and the
reference's `MMapIndexedDataset`, so a `.bin`/`.idx` pair written by
either loads here and one written here loads there:

.idx:  b"MMIDIDX\\x00\\x00" | <Q version=1 | <B dtype_code |
       <Q num_sequences | <Q num_docs |
       int32[num_sequences] sizes | int64[num_sequences] byte pointers |
       int64[num_docs] doc_idx (sequence index of each document start)
.bin:  raw token array, C-order, dtype per the code table.

numpy only: reading a sample is a zero-copy view of the mmap.
"""

from __future__ import annotations

import os
import shutil
import struct
from typing import Optional

import numpy as np

_HDR_MAGIC = b"MMIDIDX\x00\x00"

# dtype code -> dtype (6 is float32 and 7 float64, as the reference's
# preprocess writes them)
DTYPES = {
    1: np.uint8,
    2: np.int8,
    3: np.int16,
    4: np.int32,
    5: np.int64,
    6: np.float32,
    7: np.float64,
    8: np.uint16,
}


def dtype_code(dtype) -> int:
    for k, v in DTYPES.items():
        if np.dtype(v) == np.dtype(dtype):
            return k
    raise ValueError(dtype)


def best_fitting_dtype(vocab_size: Optional[int] = None):
    """uint16 below 65500 ids, else int32."""
    if vocab_size is not None and vocab_size < 65500:
        return np.uint16
    return np.int32


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


class _Index:
    """Reader for the .idx file (mmap-backed)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            magic = f.read(9)
            if magic != _HDR_MAGIC:
                raise ValueError(f"{path}: bad magic {magic!r}; not an "
                                 f"MMapIndexedDataset index")
            (version,) = struct.unpack("<Q", f.read(8))
            if version != 1:
                raise ValueError(f"{path}: index version {version}, "
                                 f"expected 1")
            (code,) = struct.unpack("<B", f.read(1))
            self.dtype = np.dtype(DTYPES[code])
            (self._len,) = struct.unpack("<Q", f.read(8))
            (self._doc_count,) = struct.unpack("<Q", f.read(8))
            offset = f.tell()
        self._buffer_mmap = np.memmap(path, mode="r", order="C")
        buf = memoryview(self._buffer_mmap)
        self.sizes = np.frombuffer(buf, np.int32, count=self._len,
                                   offset=offset)
        self.pointers = np.frombuffer(buf, np.int64, count=self._len,
                                      offset=offset + self.sizes.nbytes)
        self.doc_idx = np.frombuffer(
            buf, np.int64, count=self._doc_count,
            offset=offset + self.sizes.nbytes + self.pointers.nbytes)

    def __len__(self):
        return self._len

    def close(self):
        if self._buffer_mmap is not None:
            self._buffer_mmap._mmap.close()
            self._buffer_mmap = None


def write_index(path: str, sizes, doc_idx, dtype) -> None:
    """Write a .idx for sequences of `sizes` tokens of `dtype`."""
    itemsize = np.dtype(dtype).itemsize
    pointers = np.zeros(len(sizes), np.int64)
    np.cumsum(np.asarray(sizes[:-1], np.int64) * itemsize, out=pointers[1:])
    with open(path, "wb") as f:
        f.write(_HDR_MAGIC)
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<B", dtype_code(dtype)))
        f.write(struct.pack("<Q", len(sizes)))
        f.write(struct.pack("<Q", len(doc_idx)))
        f.write(np.asarray(sizes, np.int32).tobytes(order="C"))
        f.write(pointers.tobytes(order="C"))
        f.write(np.asarray(doc_idx, np.int64).tobytes(order="C"))


class MMapIndexedDataset:
    """Reader: `ds[i]` is sequence i, `ds.get(i, offset, length)` a slice
    of it, both numpy views of the mmap."""

    def __init__(self, path_prefix: str):
        self._path = path_prefix
        self._index = _Index(index_file_path(path_prefix))
        self._bin_mmap = np.memmap(data_file_path(path_prefix), mode="r",
                                   order="C")
        self._bin_buffer = memoryview(self._bin_mmap)

    def __len__(self):
        return len(self._index)

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return self.get(idx)
        raise TypeError(idx)

    def get(self, idx: int, offset: int = 0, length: Optional[int] = None):
        """`length` tokens of sequence `idx` from `offset` (the rest of it
        when None), without reading the others."""
        ptr = self._index.pointers[idx]
        size = self._index.sizes[idx]
        if length is None:
            length = size - offset
        ptr += offset * self._index.dtype.itemsize
        return np.frombuffer(self._bin_buffer, self._index.dtype,
                             count=length, offset=ptr)

    @property
    def sizes(self):
        return self._index.sizes

    @property
    def doc_idx(self):
        return self._index.doc_idx

    @property
    def dtype(self):
        return self._index.dtype

    def close(self):
        self._bin_mmap._mmap.close()
        self._index.close()

    @staticmethod
    def exists(path_prefix: str) -> bool:
        return os.path.exists(index_file_path(path_prefix)) and \
            os.path.exists(data_file_path(path_prefix))


class MMapIndexedDatasetBuilder:
    """Writer used by preprocess_data and merges: `add_item` appends a
    sequence to the .bin, `end_document` closes a document, `finalize`
    writes the .idx."""

    def __init__(self, out_file: str, dtype=np.int32):
        self._data_file = open(out_file, "wb")
        self._dtype = np.dtype(dtype)
        self._sizes: list = []
        self._doc_idx = [0]

    def add_item(self, tokens) -> None:
        arr = np.asarray(tokens, dtype=self._dtype)
        self._data_file.write(arr.tobytes(order="C"))
        self._sizes.append(arr.size)

    def end_document(self) -> None:
        self._doc_idx.append(len(self._sizes))

    def merge_file_(self, another_prefix: str) -> None:
        """Append the dataset at `another_prefix` (same dtype)."""
        index = _Index(index_file_path(another_prefix))
        if index.dtype != self._dtype:
            raise ValueError(f"{another_prefix}: dtype {index.dtype}, this "
                             f"builder writes {self._dtype}")
        offset = len(self._sizes)
        self._sizes.extend(index.sizes.tolist())
        self._doc_idx.extend((index.doc_idx[1:] + offset).tolist())
        index.close()
        with open(data_file_path(another_prefix), "rb") as f:
            shutil.copyfileobj(f, self._data_file)

    def finalize(self, index_file: str) -> None:
        self._data_file.close()
        write_index(index_file, self._sizes, self._doc_idx, self._dtype)


def make_dataset(path_prefix: str, impl: str = "mmap"):
    """The mmap dataset at `path_prefix` ('mmap' and 'infer' name it; the
    legacy lazy/cached formats are not read)."""
    if impl in ("mmap", "infer"):
        return MMapIndexedDataset(path_prefix)
    raise ValueError(f"dataset impl {impl!r} not supported (use mmap)")
