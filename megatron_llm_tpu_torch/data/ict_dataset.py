"""Inverse Cloze Task dataset for biencoder pretraining (port of
data/ict_dataset.py, host numpy).

`ICTDataset` (ref megatron/data/ict_dataset.py :50-158) and the cached
block map `get_block_samples_mapping` (ref realm_dataset_utils.py
:156-201), whose rows come from the g++ `build_blocks_mapping`
(data/csrc/helpers.cpp) and are cached beside the corpus under the JAX
package's file name, so either package reads the other's. A sample is a
pseudo-query, one random sentence of an evidence block, and the block
itself with its document's title; the query is taken out of the block
1 - query_in_block_prob of the time.

The draws come from one `random.Random(seed)` per dataset, in the order
samples are read (JAX :79, :109-110): a sample depends on every sample
the dataset gave before it, as in the JAX package, so the two give the
same samples when read in the same order.
"""

from __future__ import annotations

import itertools
import os
import random
import time

import numpy as np

from megatron_llm_tpu_torch.data import helpers


def get_block_samples_mapping(block_dataset, title_dataset, data_prefix,
                              num_epochs, max_num_samples, max_seq_length,
                              seed, name, use_one_sent_docs=False
                              ) -> np.ndarray:
    """Cached (start_sent, end_sent, doc, block_id) rows (JAX :23-64):
    blocks of at most max_seq_length - 3 tokens with the title, written
    to a temporary file and renamed into place."""
    if not num_epochs:
        if not max_num_samples:
            raise ValueError(
                "Need to specify either max_num_samples or num_epochs")
        num_epochs = np.iinfo(np.int32).max - 1
    if not max_num_samples:
        max_num_samples = np.iinfo(np.int64).max - 1

    fname = data_prefix + f"_{name}_ict_indexmap"
    if num_epochs != (np.iinfo(np.int32).max - 1):
        fname += f"_{num_epochs}ep"
    if max_num_samples != (np.iinfo(np.int64).max - 1):
        fname += f"_{max_num_samples}mns"
    fname += f"_{max_seq_length}msl_{seed}s.npy"

    if not os.path.isfile(fname):
        t0 = time.time()
        mapping = helpers.build_blocks_mapping(
            np.asarray(block_dataset.doc_idx, np.int64),
            np.asarray(block_dataset.sizes, np.int32),
            np.asarray(title_dataset.sizes, np.int32), num_epochs,
            max_num_samples,
            # -3 for [CLS] + 2x[SEP] (ref: realm_dataset_utils.py:183)
            max_seq_length - 3, seed, use_one_sent_blocks=use_one_sent_docs)
        tmp = f"{fname}.tmp{os.getpid()}.npy"
        with open(tmp, "wb") as f:
            np.save(f, mapping, allow_pickle=True)
        os.replace(tmp, fname)
        print(f" > built block samples mapping ({len(mapping)} blocks, "
              f"{time.time() - t0:.2f}s)", flush=True)
    return np.load(fname, allow_pickle=True, mmap_mode="r")


class ICTDataset:
    """ref: ICTDataset ict_dataset.py:50-158."""

    # a sample depends on the samples read before it: a data-parallel
    # rank reads every row of a global microbatch (data/data_samplers.py)
    reads_in_order = True

    def __init__(self, name, block_dataset, title_dataset, data_prefix,
                 num_epochs, max_num_samples, max_seq_length,
                 query_in_block_prob, seed, tokenizer, use_titles=True,
                 use_one_sent_docs=False):
        self.name = name
        self.seed = seed
        self.max_seq_length = max_seq_length
        self.query_in_block_prob = query_in_block_prob
        self.block_dataset = block_dataset
        self.title_dataset = title_dataset
        self.rng = random.Random(seed)
        self.use_titles = use_titles
        self.use_one_sent_docs = use_one_sent_docs

        self.samples_mapping = get_block_samples_mapping(
            block_dataset, title_dataset, data_prefix, num_epochs,
            max_num_samples, max_seq_length, seed, name, use_one_sent_docs)
        self.cls_id = tokenizer.cls
        self.sep_id = tokenizer.sep
        self.pad_id = tokenizer.pad

    def __len__(self):
        return len(self.samples_mapping)

    def __getitem__(self, idx):
        start_idx, end_idx, doc_idx, block_idx = (
            int(x) for x in self.samples_mapping[idx])
        if self.use_titles:
            title = list(np.asarray(self.title_dataset[doc_idx]))
            title_pad_offset = 3 + len(title)
        else:
            title = None
            title_pad_offset = 2
        block = [list(np.asarray(self.block_dataset[i]))
                 for i in range(start_idx, end_idx)]
        if len(block) < 2 and not (self.use_one_sent_docs
                                   or self.query_in_block_prob == 1):
            raise ValueError(f"block {block_idx} of document {doc_idx} has "
                             f"one sentence: the query would empty it")

        rand_sent_idx = self.rng.randint(0, len(block) - 1)
        if self.rng.random() < self.query_in_block_prob:
            query = list(block[rand_sent_idx])
        else:
            query = block.pop(rand_sent_idx)

        query = query[: self.max_seq_length - 2]
        block_flat = list(itertools.chain(*block))[
            : self.max_seq_length - title_pad_offset]

        query_tokens, query_pad_mask = self.concat_and_pad_tokens(query)
        context_tokens, context_pad_mask = self.concat_and_pad_tokens(
            block_flat, title)
        return {
            "query_tokens": query_tokens,
            "query_pad_mask": query_pad_mask,
            "context_tokens": context_tokens,
            "context_pad_mask": context_pad_mask,
            "block_data": np.array([start_idx, end_idx, doc_idx, block_idx],
                                   np.int64),
        }

    def get_block(self, start_idx, end_idx, doc_idx):
        """An evidence block with its title, for indexing (ref:
        ict_dataset.py:127-136): (tokens, pad mask)."""
        block = [list(np.asarray(self.block_dataset[i]))
                 for i in range(start_idx, end_idx)]
        title = list(np.asarray(self.title_dataset[int(doc_idx)]))
        block_flat = list(itertools.chain(*block))[
            : self.max_seq_length - (3 + len(title))]
        return self.concat_and_pad_tokens(block_flat, title)

    def get_null_block(self):
        """The empty block: [CLS] [SEP] [SEP] and padding."""
        return self.concat_and_pad_tokens([], [])

    def concat_and_pad_tokens(self, tokens, title=None):
        """[CLS] (title [SEP])? tokens [SEP], padded to max_seq_length:
        (tokens, pad mask) int64 (ref: :144-158)."""
        tokens = list(tokens)
        if title is None:
            tokens = [self.cls_id] + tokens + [self.sep_id]
        else:
            tokens = ([self.cls_id] + list(title) + [self.sep_id]
                      + tokens + [self.sep_id])
        if len(tokens) > self.max_seq_length:
            raise ValueError(f"{len(tokens)} tokens exceed max_seq_length "
                             f"{self.max_seq_length}")
        num_pad = self.max_seq_length - len(tokens)
        pad_mask = np.array([1] * len(tokens) + [0] * num_pad, np.int64)
        tokens = np.array(tokens + [self.pad_id] * num_pad, np.int64)
        return tokens, pad_mask
