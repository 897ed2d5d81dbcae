"""Train/valid/test datasets of a sentence-split corpus for the encoder
family (port of data/dataset_utils.py, its BERT side).

One sentence-level indexed corpus is split by document ranges (ref
megatron/data/dataset_utils.py:421-594); each split's sample map covers
only its range, through a read-only view of the corpus. T5's dataset is
a later slice and raises by name.
"""

from __future__ import annotations

import numpy as np

from megatron_llm_tpu_torch.data.bert_dataset import BertDataset
from megatron_llm_tpu_torch.data.gpt_dataset import (
    get_train_valid_test_split_,
)
from megatron_llm_tpu_torch.data.indexed_dataset import make_dataset


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
    """(train, valid, test) BertDatasets over one corpus, None for a
    split with no documents or no samples asked of it (JAX :44-97)."""
    if dataset_type == "t5":
        raise ValueError("the T5 dataset is not ported yet (the remaining "
                         "model families, ROADMAP.md A6)")
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
        return BertDataset(
            name=name, indexed_dataset=view, data_prefix=data_prefix,
            num_epochs=None,
            max_num_samples=train_valid_test_num_samples[index],
            masked_lm_prob=masked_lm_prob, max_seq_length=max_seq_length,
            short_seq_prob=short_seq_prob, seed=seed, tokenizer=tokenizer,
            binary_head=binary_head)

    return (build_split(0, "train"), build_split(1, "valid"),
            build_split(2, "test"))
