"""Prompt tokenization / generation detokenization (port of
inference/tokenization.py)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def tokenize_prompts(tokenizer, prompts: List[str], tokens_to_generate: int,
                     add_BOS: bool = False, pad_to_multiple: int = 64,
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (tokens (b, max_len) int32 right-padded with eod, lengths (b,)).
    max_len = longest prompt + tokens_to_generate, rounded up to a
    multiple of `pad_to_multiple`."""
    if add_BOS:
        bos = getattr(tokenizer, "bos", None)
        assert bos is not None, "tokenizer has no BOS token"
        prompt_ids = [[bos] + tokenizer.tokenize(p) for p in prompts]
    else:
        prompt_ids = [tokenizer.tokenize(p) for p in prompts]
    lengths = np.asarray([len(p) for p in prompt_ids], np.int32)
    max_len = int(lengths.max()) + tokens_to_generate
    if pad_to_multiple > 1:
        max_len = -(-max_len // pad_to_multiple) * pad_to_multiple
    tokens = np.full((len(prompts), max_len), tokenizer.eod, np.int32)
    for i, ids in enumerate(prompt_ids):
        tokens[i, :len(ids)] = ids
    return tokens, lengths


def detokenize_generations(tokenizer, tokens: np.ndarray, lengths: np.ndarray,
                           return_segments: bool = False):
    """-> texts, or (texts, per-token segments)."""
    texts = []
    segments: List[List[str]] = []
    for row, n in zip(np.asarray(tokens), np.asarray(lengths)):
        ids = [int(t) for t in row[:int(n)]]
        texts.append(tokenizer.detokenize(ids))
        if return_segments:
            segments.append([tokenizer.detokenize([tid]) for tid in ids])
    if return_segments:
        return texts, segments
    return texts
