"""Weighted mix of datasets (port of data/blendable_dataset.py)."""

from __future__ import annotations

import numpy as np

from megatron_llm_tpu_torch.data import helpers


class BlendableDataset:
    """Sample i comes from dataset `dataset_index[i]`, at its
    `dataset_sample_index[i]`-th sample: the interleave of
    `helpers.build_blending_indices` over the normalised weights."""

    def __init__(self, datasets, weights):
        if len(datasets) != len(weights):
            raise ValueError(f"{len(datasets)} datasets, {len(weights)} "
                             f"weights")
        if len(datasets) >= 255:
            raise ValueError("at most 254 datasets (uint8 index)")
        self.datasets = datasets
        self.size = sum(len(d) for d in datasets)
        weights = np.asarray(weights, np.float64)
        if not np.sum(weights) > 0.0:
            raise ValueError(f"weights {weights} sum to no positive total")
        weights = weights / np.sum(weights)
        self.dataset_index, self.dataset_sample_index = \
            helpers.build_blending_indices(weights, self.size)

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        d = self.dataset_index[idx]
        s = self.dataset_sample_index[idx]
        # the modulo covers the 0.5% headroom each part is built with
        return self.datasets[d][s % len(self.datasets[d])]
