"""Sample-building utilities of the downstream tasks (port of
tasks/data_utils.py, host numpy): [CLS] A [SEP] B [SEP] with tokentypes
and padding, the A/B trim loop and text cleaning (ref
tasks/data_utils.py)."""

from __future__ import annotations

import numpy as np


def clean_text(text: str) -> str:
    """ref: clean_text (data_utils.py:99-107)."""
    text = text.replace("\n", " ").replace("\t", " ")
    for _ in range(3):
        text = text.replace("  ", " ")
    return text.strip()


def build_sample(ids, types, paddings, label, unique_id) -> dict:
    """ref: build_sample (data_utils.py:20-32)."""
    return {
        "text": np.array(ids, np.int64),
        "types": np.array(types, np.int64),
        "padding_mask": np.array(paddings, np.int64),
        "label": int(label),
        "uid": int(unique_id),
    }


def build_tokens_types_paddings_from_text(text_a, text_b, tokenizer,
                                          max_seq_length):
    """ref: data_utils.py:35-46."""
    a_ids = tokenizer.tokenize(text_a)
    b_ids = tokenizer.tokenize(text_b) if text_b is not None else None
    return build_tokens_types_paddings_from_ids(
        a_ids, b_ids, max_seq_length, tokenizer.cls, tokenizer.sep,
        tokenizer.pad,
    )


def build_tokens_types_paddings_from_ids(a_ids, b_ids, max_seq_length,
                                         cls_id, sep_id, pad_id):
    """ref: data_utils.py:49-97 — trim A (and tail-trim B) to fit, then
    [CLS] A [SEP] [B [SEP]] + padding."""
    a_ids = list(a_ids)
    b_ids = list(b_ids) if b_ids is not None else None
    # room for [CLS] A [SEP] (+ B [SEP])
    budget = max_seq_length - (3 if b_ids is not None else 2)
    if b_ids is None:
        a_ids = a_ids[:budget]
    else:
        while len(a_ids) + len(b_ids) > budget:
            if len(a_ids) > len(b_ids):
                a_ids.pop()
            else:
                b_ids.pop()

    ids = [cls_id] + a_ids + [sep_id]
    types = [0] * len(ids)
    if b_ids is not None:
        ids += b_ids + [sep_id]
        types += [1] * (len(b_ids) + 1)
    paddings = [1] * len(ids)
    n_pad = max_seq_length - len(ids)
    ids += [pad_id] * n_pad
    types += [pad_id] * n_pad
    paddings += [0] * n_pad
    return ids, types, paddings
