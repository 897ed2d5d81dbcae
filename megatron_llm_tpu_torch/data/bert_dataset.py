"""BERT pretraining dataset: sentence pairs, masked LM and SOP labels
(port of data/bert_dataset.py, host numpy).

`BertDataset`, `build_training_sample` and the cached sample map
`get_samples_mapping` (ref megatron/data/bert_dataset.py and
dataset_utils.py:643-741). The sentence-pair map comes from the g++
`build_mapping` (data/csrc/helpers.cpp) and is cached beside the corpus
under the JAX package's file name, so either package reads the other's;
sample idx draws from RandomState(seed + idx) in the JAX package's
order, so every field equals the JAX package's.
"""

from __future__ import annotations

import os
import time

import numpy as np

from megatron_llm_tpu_torch.data import helpers
from megatron_llm_tpu_torch.data.masked_lm import (
    create_masked_lm_predictions,
    create_tokens_and_tokentypes,
    get_a_and_b_segments,
    pad_and_convert_to_numpy,
    truncate_segments,
)


def get_samples_mapping(indexed_dataset, data_prefix, num_epochs,
                        max_num_samples, max_seq_length, short_seq_prob,
                        seed, name, binary_head,
                        build_cache: bool = True) -> np.ndarray:
    """Cached (start_sent, end_sent, target_len) sample map
    (ref: dataset_utils.py:643-741). Single-controller: no barrier needed;
    the cache write is temp+atomic-rename like the GPT index caches."""
    if not num_epochs:
        if not max_num_samples:
            raise ValueError(
                "Need to specify either max_num_samples or num_epochs"
            )
        num_epochs = np.iinfo(np.int32).max - 1
    if not max_num_samples:
        max_num_samples = np.iinfo(np.int64).max - 1

    fname = data_prefix + f"_{name}_indexmap"
    if num_epochs != (np.iinfo(np.int32).max - 1):
        fname += f"_{num_epochs}ep"
    if max_num_samples != (np.iinfo(np.int64).max - 1):
        fname += f"_{max_num_samples}mns"
    fname += f"_{max_seq_length}msl_{short_seq_prob:0.2f}ssp_{seed}s"
    # The split is a DOC-RANGE view; a different --split must not reuse a
    # mapping built for another doc range (the reference shares this wart
    # — its filename omits the range too, dataset_utils.py:653-668).
    doc_idx = np.asarray(indexed_dataset.doc_idx, np.int64)
    fname += f"_{int(doc_idx[0])}-{int(doc_idx[-1])}x{len(doc_idx)}docs.npy"

    if not os.path.isfile(fname):
        t0 = time.time()
        mapping = helpers.build_mapping(
            np.asarray(indexed_dataset.doc_idx, np.int64),
            np.asarray(indexed_dataset.sizes, np.int32),
            num_epochs, max_num_samples, max_seq_length, short_seq_prob,
            seed, min_num_sent=2 if binary_head else 1,
        )
        if not build_cache:
            return mapping
        tmp = f"{fname}.tmp{os.getpid()}.npy"
        with open(tmp, "wb") as f:
            np.save(f, mapping, allow_pickle=True)
        os.replace(tmp, fname)
        print(f" > built and saved samples mapping ({len(mapping)} samples,"
              f" {time.time() - t0:.2f}s) to {fname}", flush=True)
    return np.load(fname, allow_pickle=True, mmap_mode="r")


def build_training_sample(sample, target_seq_length, max_seq_length,
                          vocab_id_list, vocab_id_to_token_dict, cls_id,
                          sep_id, mask_id, pad_id, masked_lm_prob, np_rng,
                          binary_head) -> dict:
    """ref: bert_dataset.py:80-162 — returns the reference's exact field
    set (text/types/labels/is_random/loss_mask/padding_mask/truncated)."""
    if binary_head:
        assert len(sample) > 1
    assert target_seq_length <= max_seq_length

    if binary_head:
        tokens_a, tokens_b, is_next_random = get_a_and_b_segments(sample,
                                                                  np_rng)
    else:
        tokens_a = []
        for s in sample:
            tokens_a.extend(s)
        tokens_b, is_next_random = [], False

    truncated = truncate_segments(tokens_a, tokens_b, len(tokens_a),
                                  len(tokens_b), target_seq_length, np_rng)
    tokens, tokentypes = create_tokens_and_tokentypes(tokens_a, tokens_b,
                                                      cls_id, sep_id)
    max_predictions_per_seq = masked_lm_prob * target_seq_length
    tokens, masked_positions, masked_labels, _, _ = \
        create_masked_lm_predictions(
            tokens, vocab_id_list, vocab_id_to_token_dict, masked_lm_prob,
            cls_id, sep_id, mask_id, max_predictions_per_seq, np_rng,
        )
    tokens_np, tokentypes_np, labels_np, padding_mask_np, loss_mask_np = \
        pad_and_convert_to_numpy(tokens, tokentypes, masked_positions,
                                 masked_labels, pad_id, max_seq_length)
    return {
        "text": tokens_np,
        "types": tokentypes_np,
        "labels": labels_np,
        "is_random": int(is_next_random),
        "loss_mask": loss_mask_np,
        "padding_mask": padding_mask_np,
        "truncated": int(truncated),
    }


class BertDataset:
    """ref: BertDataset bert_dataset.py:28-78."""

    def __init__(self, name, indexed_dataset, data_prefix, num_epochs,
                 max_num_samples, masked_lm_prob, max_seq_length,
                 short_seq_prob, seed, tokenizer,
                 binary_head: bool = True):
        self.name = name
        self.indexed_dataset = indexed_dataset
        self.seed = seed
        self.masked_lm_prob = masked_lm_prob
        self.max_seq_length = max_seq_length
        self.binary_head = binary_head

        # -3 accounts for [CLS] + 2x[SEP] (ref: bert_dataset.py:44)
        self.samples_mapping = get_samples_mapping(
            indexed_dataset, data_prefix, num_epochs, max_num_samples,
            self.max_seq_length - 3, short_seq_prob, seed, name,
            binary_head,
        )
        self.vocab_id_list = list(tokenizer.inv_vocab.keys())
        self.vocab_id_to_token_dict = tokenizer.inv_vocab
        self.cls_id = tokenizer.cls
        self.sep_id = tokenizer.sep
        self.mask_id = tokenizer.mask
        self.pad_id = tokenizer.pad

    def __len__(self):
        return self.samples_mapping.shape[0]

    def __getitem__(self, idx):
        start_idx, end_idx, seq_length = self.samples_mapping[idx]
        sample = [np.asarray(self.indexed_dataset[i])
                  for i in range(start_idx, end_idx)]
        np_rng = np.random.RandomState(seed=((self.seed + idx) % 2**32))
        return build_training_sample(
            sample, seq_length, self.max_seq_length, self.vocab_id_list,
            self.vocab_id_to_token_dict, self.cls_id, self.sep_id,
            self.mask_id, self.pad_id, self.masked_lm_prob, np_rng,
            self.binary_head,
        )
