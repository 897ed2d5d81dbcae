"""Masked-LM sample construction shared by the BERT and T5 datasets
(port of data/masked_lm.py, host numpy).

Segment pairing, pair truncation, [CLS]/[SEP]/tokentype assembly and
`create_masked_lm_predictions` (ref megatron/data/dataset_utils.py
:95-388): n-gram whole-word masking with the 80/10/10 BERT corruption or
T5's sentinel masking, and the BERT-side padding. Every draw is the JAX
package's, from the same numpy RandomState calls in the same order, so
a sample is the JAX package's (and the reference's) field for field.
"""

from __future__ import annotations

import collections
from typing import List, Sequence, Tuple

import numpy as np

MaskedLmInstance = collections.namedtuple("MaskedLmInstance",
                                          ["index", "label"])


def is_start_piece(piece: str) -> bool:
    """BERT wordpiece convention: continuation pieces start with '##'
    (ref: dataset_utils.py:178-185)."""
    return not piece.startswith("##")


def get_a_and_b_segments(sample: Sequence[List[int]], np_rng):
    """Split a multi-sentence sample into (A, B, is_next_random)
    (ref: :95-125). 50% of the time the segments are swapped — that is the
    sentence-order-prediction negative."""
    n_sentences = len(sample)
    assert n_sentences > 1, "make sure each sample has at least two sentences."
    a_end = 1
    if n_sentences >= 3:
        a_end = np_rng.randint(1, n_sentences)
    tokens_a: List[int] = []
    for j in range(a_end):
        tokens_a.extend(sample[j])
    tokens_b: List[int] = []
    for j in range(a_end, n_sentences):
        tokens_b.extend(sample[j])
    is_next_random = False
    if np_rng.random() < 0.5:
        is_next_random = True
        tokens_a, tokens_b = tokens_b, tokens_a
    return tokens_a, tokens_b, is_next_random


def truncate_segments(tokens_a, tokens_b, len_a, len_b, max_num_tokens,
                      np_rng) -> bool:
    """Trim the pair to max_num_tokens, popping randomly from either end
    of the longer segment (ref: :127-145). Mutates the lists."""
    assert len_a > 0
    if len_a + len_b <= max_num_tokens:
        return False
    while len_a + len_b > max_num_tokens:
        if len_a > len_b:
            len_a -= 1
            tokens = tokens_a
        else:
            len_b -= 1
            tokens = tokens_b
        if np_rng.random() < 0.5:
            del tokens[0]
        else:
            tokens.pop()
    return True


def create_tokens_and_tokentypes(tokens_a, tokens_b, cls_id, sep_id):
    """[CLS] A [SEP] B [SEP] with 0/1 tokentypes (ref: :147-176)."""
    tokens = [cls_id] + list(tokens_a) + [sep_id]
    tokentypes = [0] * (len(tokens_a) + 2)
    if tokens_b:
        tokens += list(tokens_b) + [sep_id]
        tokentypes += [1] * (len(tokens_b) + 1)
    return tokens, tokentypes


def create_masked_lm_predictions(
    tokens: List[int],
    vocab_id_list,
    vocab_id_to_token_dict,
    masked_lm_prob: float,
    cls_id: int,
    sep_id: int,
    mask_id: int,
    max_predictions_per_seq,
    np_rng,
    max_ngrams: int = 3,
    do_whole_word_mask: bool = True,
    favor_longer_ngram: bool = False,
    geometric_dist: bool = False,
    masking_style: str = "bert",
) -> Tuple[List[int], List[int], List[int], List[int], list]:
    """-> (output_tokens, masked_positions, masked_labels, token_boundary,
    masked_spans)  (ref: :187-388, minus the never-used do_permutation arm).

    bert style: 80% [MASK] / 10% keep / 10% random-vocab per position.
    t5 style: every selected position becomes mask_id; the returned
    masked_spans drive the sentinel construction in t5_dataset.
    """
    # group wordpieces into whole-word candidates
    cand_indexes: List[List[int]] = []
    token_boundary = [0] * len(tokens)
    for i, token in enumerate(tokens):
        if token == cls_id or token == sep_id:
            token_boundary[i] = 1
            continue
        if (do_whole_word_mask and cand_indexes
                and not is_start_piece(vocab_id_to_token_dict[token])):
            cand_indexes[-1].append(i)
        else:
            cand_indexes.append([i])
            if is_start_piece(vocab_id_to_token_dict[token]):
                token_boundary[i] = 1

    output_tokens = list(tokens)
    if masked_lm_prob == 0:
        return output_tokens, [], [], token_boundary, []

    num_to_predict = min(max_predictions_per_seq,
                         max(1, int(round(len(tokens) * masked_lm_prob))))

    ngrams = np.arange(1, max_ngrams + 1, dtype=np.int64)
    if not geometric_dist:
        pvals = 1.0 / np.arange(1, max_ngrams + 1)
        pvals /= pvals.sum(keepdims=True)
        if favor_longer_ngram:
            pvals = pvals[::-1]

    # per starting candidate, the list of 1..max_ngrams n-gram windows
    ngram_indexes = []
    for idx in range(len(cand_indexes)):
        ngram_index = [cand_indexes[idx:idx + n] for n in ngrams]
        ngram_indexes.append(ngram_index)
    np_rng.shuffle(ngram_indexes)

    masked_lms: List[MaskedLmInstance] = []
    masked_spans: List[MaskedLmInstance] = []
    covered = set()
    for cand_index_set in ngram_indexes:
        if len(masked_lms) >= num_to_predict:
            break
        if not cand_index_set:
            continue
        if not geometric_dist:
            n = np_rng.choice(
                ngrams[: len(cand_index_set)],
                p=pvals[: len(cand_index_set)]
                / pvals[: len(cand_index_set)].sum(keepdims=True),
            )
        else:
            # SpanBERT p=0.2 geometric, clipped (ref: :276-280)
            n = min(np_rng.geometric(0.2), max_ngrams)

        index_set = sum(cand_index_set[n - 1], [])
        n -= 1
        # back off to shorter n-grams rather than exceed the budget
        while len(masked_lms) + len(index_set) > num_to_predict:
            if n == 0:
                break
            index_set = sum(cand_index_set[n - 1], [])
            n -= 1
        if len(masked_lms) + len(index_set) > num_to_predict:
            continue
        if any(index in covered for index in index_set):
            continue
        for index in index_set:
            covered.add(index)
            if masking_style == "bert":
                if np_rng.random() < 0.8:
                    masked_token = mask_id
                elif np_rng.random() < 0.5:
                    masked_token = tokens[index]
                else:
                    masked_token = vocab_id_list[
                        np_rng.randint(0, len(vocab_id_list))
                    ]
            elif masking_style == "t5":
                masked_token = mask_id
            else:
                raise ValueError(f"invalid masking style {masking_style}")
            output_tokens[index] = masked_token
            masked_lms.append(MaskedLmInstance(index=index,
                                               label=tokens[index]))
        masked_spans.append(MaskedLmInstance(
            index=index_set, label=[tokens[i] for i in index_set]
        ))

    assert len(masked_lms) <= num_to_predict
    # the reference shuffles again here for its (unused) permutation arm
    # (:328); keep the call so the RandomState stream stays draw-for-draw
    # compatible with reference-built samples
    np_rng.shuffle(ngram_indexes)
    masked_lms.sort(key=lambda x: x.index)
    # spans sorted by first position so sentinel order matches text order
    masked_spans.sort(key=lambda x: x.index[0])
    masked_positions = [m.index for m in masked_lms]
    masked_labels = [m.label for m in masked_lms]
    return (output_tokens, masked_positions, masked_labels, token_boundary,
            masked_spans)


def pad_and_convert_to_numpy(tokens, tokentypes, masked_positions,
                             masked_labels, pad_id, max_seq_length):
    """BERT-side padding (ref: :389-419). Labels use -1 filler; callers
    clamp before CE and rely on loss_mask (the reference does the same)."""
    num_tokens = len(tokens)
    padding_length = max_seq_length - num_tokens
    assert padding_length >= 0
    assert len(tokentypes) == num_tokens
    assert len(masked_positions) == len(masked_labels)

    filler = [pad_id] * padding_length
    tokens_np = np.array(tokens + filler, dtype=np.int64)
    tokentypes_np = np.array(tokentypes + filler, dtype=np.int64)
    padding_mask_np = np.array([1] * num_tokens + [0] * padding_length,
                               dtype=np.int64)
    labels = [-1] * max_seq_length
    loss_mask = [0] * max_seq_length
    for pos, lab in zip(masked_positions, masked_labels):
        assert pos < num_tokens
        labels[pos] = lab
        loss_mask[pos] = 1
    return (tokens_np, tokentypes_np, np.array(labels, np.int64),
            padding_mask_np, np.array(loss_mask, np.int64))
