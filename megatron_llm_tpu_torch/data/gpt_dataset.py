"""GPT pretraining dataset: documents stitched into samples, with cached
index mappings (port of data/gpt_dataset.py).

The doc, sample and shuffle indices are built as the JAX package builds
them (the same RNG calls in the same order) and cached under the same
file names, `{prefix}_{name}_indexmap_{ns}ns_{sl}sl_{seed}s_*.npy`, so
the same corpus gives the same samples in the same order on both, and
each reads the other's cache. One process builds the cache (rank 0 of
`torch.distributed` when it is initialised); the others wait for its
files, which appear whole: each is written to a temporary name and
renamed.
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np

from megatron_llm_tpu_torch.data import helpers
from megatron_llm_tpu_torch.data.blendable_dataset import BlendableDataset
from megatron_llm_tpu_torch.data.indexed_dataset import (
    MMapIndexedDataset,
    make_dataset,
)


def get_datasets_weights_and_num_samples(data_prefix,
                                         train_valid_test_num_samples):
    """Parse [w1, p1, w2, p2, ...] into prefixes, normalised weights and
    each dataset's sample counts (with 0.5% headroom)."""
    if len(data_prefix) % 2:
        raise ValueError(f"--data_path {data_prefix}: expected weight, "
                         f"prefix pairs")
    num_datasets = len(data_prefix) // 2
    weights = [float(data_prefix[2 * i]) for i in range(num_datasets)]
    prefixes = [str(data_prefix[2 * i + 1]) for i in range(num_datasets)]
    total = sum(weights)
    weights = [w / total for w in weights]
    nums = [[int(np.ceil(n * w * 1.005)) for n in train_valid_test_num_samples]
            for w in weights]
    return prefixes, weights, nums


class GPTDataset:
    """`ds[i]` is {"text": int64[seq_length + 1]}: the tokens of sample
    `shuffle_idx[i]`, stitched across document boundaries."""

    def __init__(self, name: str, data_prefix: str, documents: np.ndarray,
                 indexed_dataset: MMapIndexedDataset, num_samples: int,
                 seq_length: int, seed: int, build_cache: bool = True):
        self.name = name
        self.indexed_dataset = indexed_dataset
        if np.min(documents) < 0 or \
                np.max(documents) >= indexed_dataset.sizes.shape[0]:
            raise ValueError(f"{name}: document ids out of range")
        self.doc_idx, self.sample_idx, self.shuffle_idx = \
            _build_index_mappings(name, data_prefix, documents,
                                  indexed_dataset.sizes, num_samples,
                                  seq_length, seed, build_cache=build_cache)

    def __len__(self):
        # sample i spans sample_idx[i] to sample_idx[i + 1]
        return self.sample_idx.shape[0] - 1

    def __getitem__(self, idx):
        idx = self.shuffle_idx[idx]
        doc_f, off_f = self.sample_idx[idx]
        doc_l, off_l = self.sample_idx[idx + 1]
        if doc_f == doc_l:
            sample = self.indexed_dataset.get(
                self.doc_idx[doc_f], offset=off_f, length=off_l - off_f + 1)
        else:
            parts = [self.indexed_dataset.get(self.doc_idx[doc_f],
                                              offset=off_f)]
            for i in range(doc_f + 1, doc_l):
                parts.append(self.indexed_dataset.get(self.doc_idx[i]))
            parts.append(self.indexed_dataset.get(self.doc_idx[doc_l],
                                                  length=off_l + 1))
            sample = np.concatenate(parts)
        return {"text": np.asarray(sample, np.int64)}


def _num_tokens(documents, sizes) -> int:
    return int(np.sum(sizes[documents]))


def _num_epochs(tokens_per_epoch, seq_length, num_samples) -> int:
    """Epochs needed for `num_samples` samples (consecutive samples share
    one boundary token: the -1)."""
    num_epochs = 0
    total_tokens = 0
    while True:
        num_epochs += 1
        total_tokens += tokens_per_epoch
        if (total_tokens - 1) // seq_length >= num_samples:
            return num_epochs


def _build_doc_idx(documents, num_epochs, np_rng, separate_last_epoch):
    """Every document once per epoch, shuffled; the last epoch shuffled
    on its own when `separate_last_epoch`."""
    if not separate_last_epoch or num_epochs == 1:
        doc_idx = np.mgrid[0:num_epochs, 0:len(documents)][1]
        doc_idx[:] = documents
        doc_idx = doc_idx.reshape(-1).astype(np.int32)
        np_rng.shuffle(doc_idx)
        return doc_idx
    doc_idx_first = _build_doc_idx(documents, num_epochs - 1, np_rng, False)
    doc_idx_last = _build_doc_idx(documents, 1, np_rng, False)
    return np.concatenate((doc_idx_first, doc_idx_last))


def _build_shuffle_idx(num_samples, total_size, np_rng):
    """A permutation of the first `num_samples` samples, then one of the
    rest."""
    dtype_ = np.uint32
    if total_size >= (np.iinfo(np.uint32).max - 1):
        dtype_ = np.int64
    shuffle_idx_first = np.arange(0, num_samples, dtype=dtype_)
    np_rng.shuffle(shuffle_idx_first)
    if num_samples == total_size:
        return shuffle_idx_first
    shuffle_idx_last = np.arange(num_samples, total_size, dtype=dtype_)
    np_rng.shuffle(shuffle_idx_last)
    return np.concatenate((shuffle_idx_first, shuffle_idx_last))


def _is_lead_process() -> bool:
    """Rank 0 of an initialised `torch.distributed` group; True in a
    single process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def index_mapping_filenames(data_prefix, name, num_samples, seq_length,
                            seed):
    """The three cache files' names (doc, sample, shuffle)."""
    base = (f"{data_prefix}_{name}_indexmap_{num_samples}ns_"
            f"{seq_length}sl_{seed}s")
    return (base + "_doc_idx.npy", base + "_sample_idx.npy",
            base + "_shuffle_idx.npy")


def _build_index_mappings(name, data_prefix, documents, sizes, num_samples,
                          seq_length, seed, build_cache: bool = True):
    """(doc_idx, sample_idx, shuffle_idx): read from the cache files, or
    built (and written there unless `build_cache` is False)."""
    tokens_per_epoch = _num_tokens(documents, sizes)
    num_epochs = _num_epochs(tokens_per_epoch, seq_length, num_samples)
    np_rng = np.random.RandomState(seed=seed)
    files = index_mapping_filenames(data_prefix, name, num_samples,
                                    seq_length, seed)

    if not all(os.path.isfile(f) for f in files):
        # the last epoch is shuffled on its own when it contributes
        # under 80% of an epoch's samples
        if num_epochs == 1:
            separate_last_epoch = False
        else:
            num_samples_from_epochs_minus_one = (
                (num_epochs - 1) * tokens_per_epoch - 1) // seq_length
            last_epoch_num_samples = \
                num_samples - num_samples_from_epochs_minus_one
            num_samples_per_epoch = (tokens_per_epoch - 1) // seq_length
            if not 0 <= last_epoch_num_samples < num_samples_per_epoch + 1:
                raise ValueError(f"{name}: last epoch holds "
                                 f"{last_epoch_num_samples} samples")
            separate_last_epoch = last_epoch_num_samples < int(
                0.80 * num_samples_per_epoch)

        if _is_lead_process() or not build_cache:
            doc_idx = _build_doc_idx(documents, num_epochs, np_rng,
                                     separate_last_epoch)
            sample_idx = helpers.build_sample_idx(
                sizes, doc_idx, seq_length, num_epochs, tokens_per_epoch)
            if separate_last_epoch:
                num_samples_ = num_samples_from_epochs_minus_one
            else:
                num_samples_ = sample_idx.shape[0] - 1
            shuffle_idx = _build_shuffle_idx(
                num_samples_, sample_idx.shape[0] - 1, np_rng)
            if not build_cache:
                return doc_idx, sample_idx, shuffle_idx
            for fname, arr in zip(files, (doc_idx, sample_idx, shuffle_idx)):
                tmp = f"{fname}.tmp{os.getpid()}.npy"
                with open(tmp, "wb") as f:
                    np.save(f, arr, allow_pickle=True)
                os.replace(tmp, fname)
        else:
            deadline = time.time() + 600
            while not all(os.path.isfile(f) for f in files):
                if time.time() > deadline:
                    raise TimeoutError("index mapping cache never appeared")
                time.sleep(1)

    return tuple(np.load(f, allow_pickle=True, mmap_mode="r") for f in files)


def get_train_valid_test_split_(splits_string, size):
    """Document boundaries [0, a, b, size] of a '969,30,1'-style split."""
    if splits_string.find(",") != -1:
        splits = [float(s) for s in splits_string.split(",")]
    elif splits_string.find("/") != -1:
        splits = [float(s) for s in splits_string.split("/")]
    else:
        splits = [float(splits_string)]
    while len(splits) < 3:
        splits.append(0.0)
    splits = splits[:3]
    splits_sum = sum(splits)
    if not splits_sum > 0.0:
        raise ValueError(f"split {splits_string!r} sums to 0")
    splits = [split / splits_sum for split in splits]
    splits_index = [0]
    for index, split in enumerate(splits):
        splits_index.append(splits_index[index]
                            + int(round(split * float(size))))
    diff = splits_index[-1] - size
    for index in range(1, len(splits_index)):
        splits_index[index] -= diff
    return splits_index


def _build_single(data_prefix, data_impl, splits_string,
                  train_valid_test_num_samples, seq_length, seed,
                  build_cache=True):
    """One corpus split into train, valid and test by document ranges."""
    indexed_dataset = make_dataset(data_prefix, data_impl)
    total_num_docs = indexed_dataset.sizes.shape[0]
    splits = get_train_valid_test_split_(splits_string, total_num_docs)

    def build_dataset(index, name):
        if splits[index + 1] <= splits[index]:
            return None
        documents = np.arange(splits[index], splits[index + 1],
                              dtype=np.int32)
        return GPTDataset(name, data_prefix, documents, indexed_dataset,
                          train_valid_test_num_samples[index], seq_length,
                          seed, build_cache=build_cache)

    return (build_dataset(0, "train"), build_dataset(1, "valid"),
            build_dataset(2, "test"))


def build_train_valid_test_datasets(
        data_prefix, data_impl: str = "mmap",
        splits_string: str = "969,30,1",
        train_valid_test_num_samples: Sequence[int] = (0, 0, 0),
        seq_length: int = 2048, seed: int = 1234, train_data_prefix=None,
        valid_data_prefix=None, test_data_prefix=None,
        build_cache: bool = True):
    """(train, valid, test) datasets, each None where it gets no
    documents: one corpus split by `splits_string`, a weighted blend of
    corpora ([w1, p1, w2, p2, ...], each split by it), or separate
    train/valid/test prefixes (each may itself be a blend)."""
    if data_prefix is not None:
        if isinstance(data_prefix, (str, os.PathLike)):
            return _build_single(data_prefix, data_impl, splits_string,
                                 train_valid_test_num_samples, seq_length,
                                 seed, build_cache)
        if len(data_prefix) == 1:
            return _build_single(data_prefix[0], data_impl, splits_string,
                                 train_valid_test_num_samples, seq_length,
                                 seed, build_cache)
        prefixes, weights, per_ds_nums = \
            get_datasets_weights_and_num_samples(
                data_prefix, train_valid_test_num_samples)
        train_sets, valid_sets, test_sets = [], [], []
        for prefix, nums in zip(prefixes, per_ds_nums):
            tr, va, te = _build_single(prefix, data_impl, splits_string,
                                       nums, seq_length, seed, build_cache)
            if tr:
                train_sets.append(tr)
            if va:
                valid_sets.append(va)
            if te:
                test_sets.append(te)

        def blend(ds):
            return BlendableDataset(ds, weights) if ds else None

        return blend(train_sets), blend(valid_sets), blend(test_sets)

    def single(prefix, name, n):
        if prefix is None:
            return None
        if isinstance(prefix, (list, tuple)):
            if len(prefix) == 1:
                prefix = prefix[0]
            else:
                prefixes, weights, per_ds_n = \
                    get_datasets_weights_and_num_samples(prefix, [n])
                parts = [single(p, name, nn[0])
                         for p, nn in zip(prefixes, per_ds_n)]
                parts = [p for p in parts if p]
                return BlendableDataset(parts, weights) if parts else None
        ds = make_dataset(prefix, data_impl)
        documents = np.arange(ds.sizes.shape[0], dtype=np.int32)
        return GPTDataset(name, prefix, documents, ds, n, seq_length, seed,
                          build_cache=build_cache)

    return (single(train_data_prefix, "train",
                   train_valid_test_num_samples[0]),
            single(valid_data_prefix, "valid",
                   train_valid_test_num_samples[1]),
            single(test_data_prefix, "test",
                   train_valid_test_num_samples[2]))
