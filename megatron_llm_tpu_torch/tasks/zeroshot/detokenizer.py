"""Dataset-specific detokenizers for zero-shot LM evaluation (port of
tasks/zeroshot/detokenizer.py): they undo the PTB and WikiText
tokenizers' artifacts, rule for rule as the JAX package's table."""

from __future__ import annotations

import re

# (pattern, replacement, is_regex)
_PTB_RULES = [
    (" '", "'", False),
    (" \n", "\n", False),
    ("\n ", "\n", False),
    (" n't", "n't", False),
    (" N ", "1 ", False),
    ("$ 1", "$1", False),
    ("# 1", "#1", False),
]

_WIKITEXT_RULES = [
    # contractions
    ("s '", "s'", False),
    (r"/' [0-9]/", r"/'[0-9]/", True),
    # number separators
    (" @-@ ", "-", False),
    (" @,@ ", ",", False),
    (" @.@ ", ".", False),
    # punctuation
    (" : ", ": ", False),
    (" ; ", "; ", False),
    (" . ", ". ", False),
    (" ! ", "! ", False),
    (" ? ", "? ", False),
    (" , ", ", ", False),
    # double brackets
    (r"\(\s*([^\)]*?)\s*\)", r"(\1)", True),
    (r"\[\s*([^\]]*?)\s*\]", r"[\1]", True),
    (r"{\s*([^}]*?)\s*}", r"{\1}", True),
    (r"\"\s*([^\"]*?)\s*\"", r'"\1"', True),
    (r"'\s*([^']*?)\s*'", r"'\1'", True),
    # miscellaneous
    ("= = = =", "====", False),
    ("= = =", "===", False),
    ("= =", "==", False),
    (" " + chr(176) + " ", chr(176), False),
    (" \n", "\n", False),
    ("\n ", "\n", False),
    (" N ", " 1 ", False),
    (" 's", "'s", False),
]


def _apply(rules, text: str) -> str:
    for pat, repl, is_regex in rules:
        text = re.sub(pat, repl, text) if is_regex else text.replace(pat, repl)
    return text


def ptb_detokenizer(text: str) -> str:
    return _apply(_PTB_RULES, text)


def wikitext_detokenizer(text: str) -> str:
    return _apply(_WIKITEXT_RULES, text)


def lambada_detokenizer(text: str) -> str:
    return text


_DETOKENIZERS = {
    "ptb": ptb_detokenizer,
    "wiki": wikitext_detokenizer,
    "lambada": lambada_detokenizer,
}


def get_detokenizer(path: str):
    """Pick by substring of the data path (ref: detokenizer.py:62-68)."""
    for key, fn in _DETOKENIZERS.items():
        if key in path:
            return fn
    return lambda s: s
