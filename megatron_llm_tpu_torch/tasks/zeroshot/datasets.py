"""Zero-shot evaluation datasets as stacked numpy arrays (port of
tasks/zeroshot/datasets.py): the sliding-window LM windows (WikiText-103
perplexity, `--overlapping_eval`) and the LAMBADA cloze rows, strict or
not, materialised up front as (N, seq + 1) int32 tokens and (N, seq)
float32 scoring masks."""

from __future__ import annotations

import json
import math
from dataclasses import dataclass

import numpy as np

from megatron_llm_tpu_torch.tasks.zeroshot.detokenizer import (
    get_detokenizer,
)


@dataclass
class EvalData:
    """tokens (N, seq+1) int32; pad_mask (N, seq) float32 (1 = scored)."""

    tokens: np.ndarray
    pad_mask: np.ndarray
    num_original_tokens: int = 0
    num_tokenized_tokens: int = 0

    def __len__(self):
        return self.tokens.shape[0]


def build_lm_dataset(tokens, seq_len: int, pad_idx: int,
                     num_original_tokens: int, num_tokenized_tokens: int,
                     overlapping_eval: int | None = None) -> EvalData:
    """Sliding-window LM eval windows (ref: _LMDataset datasets.py:28-65).

    Window i starts at i*overlap; with overlap < seq_len only the last
    `overlap` targets of each non-first window are scored (the rest are
    context), reproducing the reference's pad_mask zeroing.
    """
    tokens = list(tokens)
    if overlapping_eval is None:
        overlapping_eval = seq_len
    overlapping_eval = max(1, overlapping_eval)
    total_targets = len(tokens) - 1
    targets = max(total_targets - overlapping_eval, 0)
    total_sequences = max(math.ceil(targets / overlapping_eval) + 1, 1)

    toks = np.full((total_sequences, seq_len + 1), pad_idx, np.int32)
    mask = np.zeros((total_sequences, seq_len), np.float32)
    for idx in range(total_sequences):
        start = idx * overlapping_eval
        window = tokens[start:start + seq_len + 1]
        n = len(window)
        toks[idx, :n] = window
        mask[idx, : max(n - 1, 0)] = 1.0
        if overlapping_eval != seq_len and idx != 0:
            mask[idx, :-overlapping_eval] = 0.0
    return EvalData(toks, mask, num_original_tokens, num_tokenized_tokens)


def build_wikitext_dataset(path: str, tokenizer, seq_len: int,
                           overlapping_eval: int | None = None) -> EvalData:
    """ref: _build_wikitext103_dataset (datasets.py:127-146): whole-file
    detokenize -> tokenize -> sliding windows; token ratio feeds the
    adjusted-ppl number."""
    with open(path, "rb") as f:
        raw = f.read().decode("utf-8")
    num_original_tokens = len(raw.strip().split(" "))
    text = get_detokenizer(path)(raw)
    ids = tokenizer.tokenize(text)
    return build_lm_dataset(
        ids, seq_len, tokenizer.eod, num_original_tokens, len(ids),
        overlapping_eval,
    )


def build_lambada_dataset(path: str, tokenizer, seq_len: int,
                          strict: bool = False) -> EvalData:
    """ref: _LambadaDataset (datasets.py:68-113): jsonl of {"text": ...};
    score only the final word's token(s). `strict` re-splits the last
    whitespace word and tokenizes it with a leading space (the harder,
    paper-faithful formulation)."""
    toks_rows, mask_rows = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            text = json.loads(line)["text"]
            if strict:
                last_word = text.split()[-1]
                start = text.rfind(last_word)
                context = tokenizer.tokenize(text[:start].strip())
                answer = tokenizer.tokenize(" " + last_word)
            else:
                ids = tokenizer.tokenize(text)
                context, answer = ids[:-1], [ids[-1]]
            row = context + answer
            mask = [0.0] * len(context) + [1.0] * len(answer)
            if len(row) > seq_len + 1:
                # left-truncate CONTEXT so the scored answer tokens always
                # survive (right-truncating would silently zero the mask
                # and make the sample unwinnable)
                row = row[-(seq_len + 1):]
                mask = mask[-(seq_len + 1):]
            elif len(row) < seq_len + 1:
                pad = seq_len + 1 - len(row)
                row = row + [tokenizer.eod] * pad
                mask = mask + [0.0] * pad
            toks_rows.append(row)
            mask_rows.append(mask[1:])
    return EvalData(
        np.asarray(toks_rows, np.int32),
        np.asarray(mask_rows, np.float32),
    )


def build_dataset(task: str, valid_data: str, tokenizer, seq_len: int,
                  overlapping_eval: int | None = None,
                  strict_lambada: bool = False) -> EvalData:
    """ref: build_dataset (datasets.py:17-25)."""
    if task == "LAMBADA":
        return build_lambada_dataset(valid_data, tokenizer, seq_len,
                                     strict_lambada)
    if task == "WIKITEXT103":
        return build_wikitext_dataset(valid_data, tokenizer, seq_len,
                                      overlapping_eval)
    raise NotImplementedError(f"dataset for {task} task is not implemented.")
