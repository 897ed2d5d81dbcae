"""Dialog evaluation metrics (port of tasks/msdp/metrics.py): ParlAI's
normalised token-level F1 (lowercase, strip punctuation and articles,
whitespace-split), averaged over pairs with a non-empty gold answer."""

from __future__ import annotations

import re
from collections import Counter
from typing import List, Optional, Tuple

import numpy as np

_RE_ART = re.compile(r"\b(a|an|the)\b")
_RE_PUNC = re.compile(r"[!\"#$%&()*+,-./:;<=>?@\[\]\\^`{|}~_']")


def normalize_answer(s: str) -> str:
    """Lowercase; drop punctuation, articles and extra whitespace
    (ref: metrics.py:17-25)."""
    s = s.lower()
    s = _RE_PUNC.sub(" ", s)
    s = _RE_ART.sub(" ", s)
    return " ".join(s.split())


def _prec_recall_f1(pred_items, gold_items) -> Tuple[float, float, float]:
    common = Counter(gold_items) & Counter(pred_items)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0, 0.0, 0.0
    precision = num_same / len(pred_items)
    recall = num_same / len(gold_items)
    return precision, recall, 2 * precision * recall / (precision + recall)


def f1_score(guess: str, answer: str
             ) -> Tuple[Optional[float], Optional[float], Optional[float]]:
    """(precision, recall, f1) for one pair; (None,)*3 when the gold
    answer is empty (excluded from averaging, ref: metrics.py:52-60)."""
    if answer == "":
        return None, None, None
    if guess == "":
        return 0.0, 0.0, 0.0
    return _prec_recall_f1(normalize_answer(guess).split(),
                           normalize_answer(answer).split())


def f1_score_all(guesses: List[str], answers: List[str]
                 ) -> Tuple[float, float, float]:
    """Mean (precision, recall, f1) over pairs (ref: metrics.py:62-76)."""
    assert len(guesses) == len(answers), (len(guesses), len(answers))
    ps, rs, fs = [], [], []
    for guess, answer in zip(guesses, answers):
        p, r, f = f1_score(guess, answer)
        if p is None:
            continue
        ps.append(p)
        rs.append(r)
        fs.append(f)
    return float(np.mean(ps)), float(np.mean(rs)), float(np.mean(fs))
