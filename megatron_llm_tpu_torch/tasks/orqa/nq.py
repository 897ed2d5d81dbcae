"""Natural Questions open-retrieval data (port of tasks/orqa/nq.py):
the NQ open TSV `question \\t ["answer", ...]` and fixed-length
[CLS] q [SEP] query batches with padding masks."""

from __future__ import annotations

import ast
import csv
from typing import List, Tuple

import numpy as np


def read_nq_file(path: str) -> List[Tuple[str, List[str]]]:
    """[(question, [answers...])] (ref: nq.py NQDataset.process_samples)."""
    rows = []
    with open(path, newline="") as f:
        for row in csv.reader(f, delimiter="\t"):
            if len(row) < 2:  # blank or truncated line: skip
                continue
            question = row[0]
            try:
                answers = ast.literal_eval(row[1])
            except (ValueError, SyntaxError):
                answers = [row[1]]
            rows.append((question, [str(a) for a in answers]))
    return rows


def tokenize_queries(tokenizer, questions: List[str], max_len: int):
    """Fixed-length [CLS] q [SEP] batches -> (tokens, pad_mask, types)
    int32 arrays (ref: nq.py build_tokens_types_paddings)."""
    b = len(questions)
    tokens = np.full((b, max_len), tokenizer.pad, np.int32)
    mask = np.zeros((b, max_len), np.int32)
    types = np.zeros((b, max_len), np.int32)
    for i, q in enumerate(questions):
        ids = [tokenizer.cls] + tokenizer.tokenize(q)[: max_len - 2] \
            + [tokenizer.sep]
        tokens[i, : len(ids)] = ids
        mask[i, : len(ids)] = 1
    return tokens, mask, types
