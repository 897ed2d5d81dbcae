"""Train/valid/test datasets of a sentence-split corpus for the encoder
family (port of data/dataset_utils.py).

One sentence-level indexed corpus is split by document ranges (ref
megatron/data/dataset_utils.py:421-594); each split's sample map covers
only its range, through a read-only view of the corpus, in BertDatasets
or, for `dataset_type="t5"`, T5Datasets.
"""

from __future__ import annotations

import numpy as np

from megatron_llm_tpu_torch.data.bert_dataset import BertDataset
from megatron_llm_tpu_torch.data.gpt_dataset import (
    get_train_valid_test_split_,
)
from megatron_llm_tpu_torch.data.indexed_dataset import make_dataset
from megatron_llm_tpu_torch.data.t5_dataset import T5Dataset


class DocRangeView:
    """The documents [start_doc, end_doc) of a sentence-level indexed
    dataset: `doc_idx` is sliced; `sizes` and items keep their absolute
    sentence indices (the sample map's rows carry them)."""

    def __init__(self, dataset, start_doc: int, end_doc: int):
        self._ds = dataset
        self.doc_idx = np.asarray(dataset.doc_idx[start_doc:end_doc + 1],
                                  np.int64)

    @property
    def sizes(self):
        return self._ds.sizes

    def __getitem__(self, idx):
        return self._ds[idx]

    def __len__(self):
        return len(self._ds)


def build_train_valid_test_datasets(data_prefix, splits_string: str,
                                    train_valid_test_num_samples,
                                    max_seq_length: int,
                                    masked_lm_prob: float,
                                    short_seq_prob: float, seed: int,
                                    tokenizer,
                                    dataset_type: str = "standard_bert",
                                    binary_head: bool = True,
                                    max_seq_length_dec=None,
                                    data_impl: str = "mmap"):
    """(train, valid, test) BertDatasets, or T5Datasets whose decoder
    side is `max_seq_length_dec` long, over one corpus; None for a split
    with no documents or no samples asked of it (JAX :44-97)."""
    if not isinstance(data_prefix, str):
        if len(data_prefix) != 1:
            raise ValueError("encoder corpora blend one prefix per call")
        data_prefix = data_prefix[0]
    indexed = make_dataset(data_prefix, data_impl)
    total_docs = len(indexed.doc_idx) - 1
    splits = get_train_valid_test_split_(splits_string, total_docs)

    def build_split(index, name):
        if splits[index + 1] <= splits[index]:
            return None
        # a split with no sample budget (the test split without test
        # iterations) is not built: the map needs samples or epochs
        if not train_valid_test_num_samples[index]:
            return None
        view = DocRangeView(indexed, splits[index], splits[index + 1])
        kwargs = dict(
            name=name, indexed_dataset=view, data_prefix=data_prefix,
            num_epochs=None,
            max_num_samples=train_valid_test_num_samples[index],
            masked_lm_prob=masked_lm_prob, max_seq_length=max_seq_length,
            short_seq_prob=short_seq_prob, seed=seed, tokenizer=tokenizer)
        if dataset_type == "t5":
            return T5Dataset(max_seq_length_dec=max_seq_length_dec, **kwargs)
        return BertDataset(binary_head=binary_head, **kwargs)

    return (build_split(0, "train"), build_split(1, "valid"),
            build_split(2, "test"))
