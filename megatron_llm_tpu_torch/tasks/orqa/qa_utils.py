"""Open-retrieval QA answer matching and top-k hit counts (port of
tasks/orqa/qa_utils.py): DPR's matching rule, unicode-normalised and
lowercased word-token subsequence containment (match_type "string") or
a regex search, on the host."""

from __future__ import annotations

import re
import unicodedata
from collections import namedtuple
from typing import Dict, List, Tuple

QAMatchStats = namedtuple("QAMatchStats", ["top_k_hits",
                                           "questions_doc_hits"])

# DPR SimpleTokenizer equivalent: alphanumeric runs or single
# non-space chars
_SIMPLE_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


def _normalize(text: str) -> str:
    return unicodedata.normalize("NFD", text)


def tokenize_words(text: str, lower: bool = True) -> List[str]:
    """DPR SimpleTokenizer.words(uncased=True) equivalent."""
    toks = _SIMPLE_RE.findall(_normalize(text))
    return [t.lower() for t in toks] if lower else toks


def has_answer(answers: List[str], text: str,
               match_type: str = "string") -> bool:
    """ref: qa_utils.py has_answer — string: token-subsequence
    containment; regex: pattern search."""
    text = _normalize(text)
    if match_type == "string":
        text_tokens = tokenize_words(text)
        for answer in answers:
            answer_tokens = tokenize_words(_normalize(answer))
            n = len(answer_tokens)
            if n == 0:
                continue
            for i in range(0, len(text_tokens) - n + 1):
                if answer_tokens == text_tokens[i:i + n]:
                    return True
        return False
    if match_type == "regex":
        for answer in answers:
            try:
                pattern = re.compile(_normalize(answer),
                                     flags=re.IGNORECASE | re.UNICODE
                                     | re.MULTILINE)
            except re.error:
                continue
            if pattern.search(text) is not None:
                return True
        return False
    raise ValueError(match_type)


def check_answer(answers: List[str], doc_ids, all_docs,
                 match_type: str = "string") -> List[bool]:
    """Per retrieved doc: does it contain any gold answer
    (ref: qa_utils.py check_answer)."""
    hits = []
    for doc_id in doc_ids:
        doc = all_docs.get(doc_id)
        text = doc[0] if doc is not None else None
        hits.append(bool(text) and has_answer(answers, text, match_type))
    return hits


def calculate_matches(
    all_docs: Dict[object, Tuple[str, str]],
    answers: List[List[str]],
    closest_docs: List[Tuple[List[object], List[float]]],
    match_type: str = "string",
) -> QAMatchStats:
    """ref: qa_utils.py calculate_matches — top_k_hits[k] = number of
    questions whose answer appears in the top-(k+1) retrieved docs."""
    scores = [
        check_answer(ans, doc_ids, all_docs, match_type)
        for ans, (doc_ids, _) in zip(answers, closest_docs)
    ]
    n_docs = len(closest_docs[0][0])
    top_k_hits = [0] * n_docs
    for question_hits in scores:
        best = next((i for i, x in enumerate(question_hits) if x), None)
        if best is not None:
            top_k_hits[best:] = [v + 1 for v in top_k_hits[best:]]
    return QAMatchStats(top_k_hits, scores)
