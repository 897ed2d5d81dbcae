"""T5 span-corruption pretraining dataset (port of data/t5_dataset.py,
host numpy).

`T5Dataset`, `build_training_sample` and `pad_and_convert_to_numpy`
(ref megatron/data/t5_dataset.py :28-216): geometric spans (max_ngrams
10, p = 0.2) drawn by `create_masked_lm_predictions(...,
masking_style="t5")`, each span replaced by a sentinel token on the
encoder side and expanded as sentinel + span on the decoder side; the
decoder input starts with [BOS], the target ends with [EOS]. The masks
stay (s,) keep vectors, as in the JAX package (models/t5.py builds the
attention masks). The sample map is BERT's (`get_samples_mapping`, the
same cached file), and sample idx draws from RandomState(seed + idx), so
every field equals the JAX package's.
"""

from __future__ import annotations

from typing import List

import numpy as np

from megatron_llm_tpu_torch.data.bert_dataset import get_samples_mapping
from megatron_llm_tpu_torch.data.masked_lm import (
    create_masked_lm_predictions,
)


def pad_and_convert_to_numpy(tokens, masked_positions, masked_labels,
                             pad_id, max_seq_length, max_seq_length_dec,
                             masked_spans, bos_id, eos_id, sentinel_tokens):
    """(text_enc, text_dec, labels, enc_mask, dec_mask, loss_mask), int64
    arrays: the encoder input with each span replaced by its sentinel,
    the decoder input [BOS] (sentinel span)*, the labels (sentinel
    span)* [EOS] with -1 padding (JAX :25-64)."""
    sentinels = list(sentinel_tokens)
    t5_input: List[int] = []
    t5_decoder_in: List[int] = [bos_id]
    t5_decoder_out: List[int] = []
    start_index = 0
    for span in masked_spans:
        flag = sentinels.pop(0)
        t5_decoder_in.append(flag)
        t5_decoder_in.extend(span.label)
        t5_decoder_out.append(flag)
        t5_decoder_out.extend(span.label)
        t5_input.extend(tokens[start_index:span.index[0]])
        t5_input.append(flag)
        start_index = span.index[-1] + 1
    t5_decoder_out.append(eos_id)
    t5_input.extend(tokens[start_index:])

    num_tokens = len(t5_input)
    padding_length = max_seq_length - num_tokens
    if padding_length < 0:
        raise ValueError(f"{num_tokens} encoder tokens exceed "
                         f"max_seq_length {max_seq_length}")
    if len(masked_positions) != len(masked_labels):
        raise ValueError("masked positions and labels differ in length")
    tokens_enc = np.array(t5_input + [pad_id] * padding_length, np.int64)
    num_tokens_dec = len(t5_decoder_in)
    padding_length_dec = max_seq_length_dec - num_tokens_dec
    if padding_length_dec < 0:
        raise ValueError(f"{num_tokens_dec} decoder tokens exceed "
                         f"max_seq_length_dec {max_seq_length_dec}")
    tokens_dec_in = np.array(t5_decoder_in + [pad_id] * padding_length_dec,
                             np.int64)
    labels = np.array(t5_decoder_out + [-1] * padding_length_dec, np.int64)
    loss_mask = np.array([1] * num_tokens_dec + [0] * padding_length_dec,
                         np.int64)
    enc_mask = np.array([1] * num_tokens + [0] * padding_length, np.int64)
    dec_mask = np.array([1] * num_tokens_dec + [0] * padding_length_dec,
                        np.int64)
    return tokens_enc, tokens_dec_in, labels, enc_mask, dec_mask, loss_mask


def build_training_sample(sample, target_seq_length, max_seq_length,
                          max_seq_length_dec, vocab_id_list,
                          vocab_id_to_token_dict, cls_id, sep_id, mask_id,
                          pad_id, masked_lm_prob, np_rng, bos_id, eos_id,
                          sentinel_tokens) -> dict:
    """One sample's fields from its sentences (JAX :67-102): the tokens
    cut to `target_seq_length`, spans masked T5-style, then padded."""
    if target_seq_length > max_seq_length:
        raise ValueError(f"target_seq_length {target_seq_length} > "
                         f"max_seq_length {max_seq_length}")
    tokens = [t for sentence in sample for t in sentence]
    truncated = len(tokens) > target_seq_length
    tokens = tokens[:target_seq_length]

    max_predictions_per_seq = masked_lm_prob * target_seq_length
    (tokens, masked_positions, masked_labels, _,
     masked_spans) = create_masked_lm_predictions(
        tokens, vocab_id_list, vocab_id_to_token_dict, masked_lm_prob,
        cls_id, sep_id, mask_id, max_predictions_per_seq, np_rng,
        max_ngrams=10, geometric_dist=True, masking_style="t5")
    tokens_enc, tokens_dec_in, labels, enc_mask, dec_mask, loss_mask = \
        pad_and_convert_to_numpy(
            tokens, masked_positions, masked_labels, pad_id, max_seq_length,
            max_seq_length_dec, masked_spans, bos_id, eos_id,
            sentinel_tokens)
    return {
        "text_enc": tokens_enc,
        "text_dec": tokens_dec_in,
        "labels": labels,
        "loss_mask": loss_mask,
        "truncated": int(truncated),
        "enc_mask": enc_mask,
        "dec_mask": dec_mask,
    }


class T5Dataset:
    """ref: T5Dataset t5_dataset.py:28-77."""

    def __init__(self, name, indexed_dataset, data_prefix, num_epochs,
                 max_num_samples, masked_lm_prob, max_seq_length,
                 max_seq_length_dec, short_seq_prob, seed, tokenizer):
        self.name = name
        self.indexed_dataset = indexed_dataset
        self.seed = seed
        self.masked_lm_prob = masked_lm_prob
        self.max_seq_length = max_seq_length
        self.max_seq_length_dec = max_seq_length_dec

        # -2: no [CLS]/[SEP] pair, but room for the sentinels (ref:
        # t5_dataset.py:46)
        self.samples_mapping = get_samples_mapping(
            indexed_dataset, data_prefix, num_epochs, max_num_samples,
            self.max_seq_length - 2, short_seq_prob, seed, name,
            binary_head=False)
        self.vocab_id_list = list(tokenizer.inv_vocab.keys())
        self.vocab_id_to_token_dict = tokenizer.inv_vocab
        self.cls_id = tokenizer.cls
        self.sep_id = tokenizer.sep
        self.mask_id = tokenizer.mask
        self.pad_id = tokenizer.pad
        self.bos_id = tokenizer.bos_token_id
        self.eos_id = tokenizer.eos_token_id
        self.sentinel_tokens = tokenizer.additional_special_tokens_ids
        if not self.sentinel_tokens:
            raise ValueError("T5 span corruption needs sentinel tokens: "
                             "pass --vocab_extra_ids 100")

    def __len__(self):
        return self.samples_mapping.shape[0]

    def __getitem__(self, idx):
        start_idx, end_idx, seq_length = self.samples_mapping[idx]
        sample = [np.asarray(self.indexed_dataset[i])
                  for i in range(start_idx, end_idx)]
        np_rng = np.random.RandomState(seed=((self.seed + idx) % 2**32))
        return build_training_sample(
            sample, seq_length, self.max_seq_length, self.max_seq_length_dec,
            self.vocab_id_list, self.vocab_id_to_token_dict, self.cls_id,
            self.sep_id, self.mask_id, self.pad_id, self.masked_lm_prob,
            np_rng, self.bos_id, self.eos_id, self.sentinel_tokens)
