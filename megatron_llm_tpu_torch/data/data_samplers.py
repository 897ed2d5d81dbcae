"""Pretraining samplers and the loader (port of data/data_samplers.py).

A sampler yields global microbatches of mbs * dp sample indices, in the
reference's order of ranks, and resumes from `consumed_samples`. The
loader stacks the samples' tokens into (num_microbatches, mbs * dp,
seq + 1) int32 arrays, asking the microbatch calculator for the count at
every step so that a batch-size rampup reaches it. With a `row_range`
[lo, hi) (parallel/multihost.process_row_range) it reads and stacks only
those rows of every global microbatch: a dp rank loads its own rows and
nothing else (JAX :115-143, :175-202).
"""

from __future__ import annotations

import numpy as np


class MegatronPretrainingSampler:
    """Sequential: samples consumed_samples, consumed_samples + 1, ..."""

    def __init__(self, total_samples: int, consumed_samples: int,
                 micro_batch_size: int, data_parallel_size: int,
                 drop_last: bool = True):
        if total_samples <= 0:
            raise ValueError(f"no samples to load ({total_samples})")
        if consumed_samples >= total_samples:
            raise ValueError(f"consumed_samples {consumed_samples} >= "
                             f"{total_samples} samples")
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = \
            micro_batch_size * data_parallel_size
        self.drop_last = drop_last

    def __len__(self):
        return self.total_samples

    def __iter__(self):
        batch = []
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.micro_batch_times_data_parallel_size:
                yield batch
                batch = []
        if len(batch) > 0 and not self.drop_last:
            yield batch


class MegatronPretrainingRandomSampler:
    """Reshuffles every epoch with numpy's RandomState(seed=epoch), as the
    JAX package does (the reference draws its permutation from
    torch.Generator)."""

    def __init__(self, total_samples: int, consumed_samples: int,
                 micro_batch_size: int, data_parallel_size: int):
        if total_samples <= 0:
            raise ValueError(f"no samples to load ({total_samples})")
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = \
            micro_batch_size * data_parallel_size
        self.last_batch_size = \
            self.total_samples % self.micro_batch_times_data_parallel_size

    def __len__(self):
        return self.total_samples

    def __iter__(self):
        active_total_samples = self.total_samples - self.last_batch_size
        epoch = self.consumed_samples // active_total_samples
        current_epoch_samples = self.consumed_samples % active_total_samples
        if current_epoch_samples % \
                self.micro_batch_times_data_parallel_size:
            raise ValueError(f"consumed_samples {self.consumed_samples} is "
                             f"not a whole number of global microbatches")
        g = np.random.RandomState(seed=epoch)
        idx_range = g.permutation(active_total_samples)[
            current_epoch_samples:]
        batch = []
        for idx in idx_range:
            batch.append(int(idx))
            if len(batch) == self.micro_batch_times_data_parallel_size:
                self.consumed_samples += len(batch)
                yield batch
                batch = []


class PretrainingDataLoader:
    """Yields (num_microbatches, mbs * dp, seq + 1) int32 'text' arrays.

    `num_microbatches` is an int or a zero-argument callable read at every
    step (the trainer's microbatch calculator, so that a batch-size
    rampup reaches the loader). A sample is a view of the mmap, so the
    loop reads on the host as it goes, with no worker processes."""

    def __init__(self, dataset, sampler, num_microbatches=1,
                 row_range=None):
        self.dataset = dataset
        self.sampler = sampler
        self.num_microbatches = num_microbatches
        self.row_range = row_range

    def __iter__(self):
        it = iter(self.sampler)
        while True:
            n = self.num_microbatches() if callable(self.num_microbatches) \
                else self.num_microbatches
            micros = []
            try:
                for _ in range(n):
                    idxs = next(it)
                    if self.row_range is not None:
                        idxs = idxs[self.row_range[0]:self.row_range[1]]
                    micros.append(np.stack(
                        [self.dataset[i]["text"] for i in idxs]
                    ).astype(np.int32))
            except StopIteration:
                return
            yield np.stack(micros)


def build_pretraining_data_loader(dataset, consumed_samples: int,
                                  micro_batch_size: int,
                                  data_parallel_size: int,
                                  num_microbatches=1,
                                  dataloader_type: str = "single",
                                  drop_last: bool = True, row_range=None):
    """The loader over `dataset` from sample `consumed_samples`, or None
    for no dataset. `dataloader_type` "single" reads in order, "cyclic"
    reshuffles every epoch; `row_range` keeps rows [lo, hi) of each
    global microbatch."""
    if dataset is None:
        return None
    if dataloader_type == "single":
        sampler = MegatronPretrainingSampler(
            total_samples=len(dataset), consumed_samples=consumed_samples,
            micro_batch_size=micro_batch_size,
            data_parallel_size=data_parallel_size, drop_last=drop_last)
    elif dataloader_type == "cyclic":
        sampler = MegatronPretrainingRandomSampler(
            total_samples=len(dataset), consumed_samples=consumed_samples,
            micro_batch_size=micro_batch_size,
            data_parallel_size=data_parallel_size)
    else:
        raise ValueError(f"unknown dataloader type {dataloader_type}")
    return PretrainingDataLoader(dataset, sampler, num_microbatches,
                                 row_range)
