"""Tokenizers (port of tokenizer/tokenizer.py, the file-free part).

Only the abstract interface and the NullTokenizer are ported; the
tokenizers that load vocabulary files come with the training slice.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional


def pad_vocab_size(orig_vocab_size: int, make_vocab_size_divisible_by: int,
                   tensor_parallel_size: int) -> int:
    multiple = make_vocab_size_divisible_by * tensor_parallel_size
    return -(-orig_vocab_size // multiple) * multiple


class AbstractTokenizer(ABC):
    def __init__(self, name: str):
        self.name = name

    @property
    @abstractmethod
    def vocab_size(self) -> int: ...

    @property
    @abstractmethod
    def vocab(self) -> dict: ...

    @property
    @abstractmethod
    def inv_vocab(self) -> dict: ...

    @abstractmethod
    def tokenize(self, text: str) -> List[int]: ...

    def detokenize(self, token_ids) -> str:
        raise NotImplementedError(
            f"detokenizer not implemented for {self.name}")

    @property
    def eod(self):
        raise NotImplementedError


class _NullTokenizer(AbstractTokenizer):
    """Integer pass-through: "12 7 3" <-> [12, 7, 3]. The vocab is
    `vocab_size + 1` ids; the extra last id is eod."""

    def __init__(self, vocab_size: int):
        super().__init__("NullTokenizer")
        self._size = int(vocab_size)

    @property
    def vocab_size(self):
        return self._size + 1

    @property
    def vocab(self):
        return {str(i): i for i in range(self.vocab_size)}

    @property
    def inv_vocab(self):
        return {i: str(i) for i in range(self.vocab_size)}

    def tokenize(self, text):
        return [int(t) for t in text.split()]

    def detokenize(self, token_ids):
        return " ".join(str(int(t)) for t in token_ids)

    @property
    def eod(self):
        return self._size


def build_tokenizer(tokenizer_type: str,
                    make_vocab_size_divisible_by: int = 128,
                    tensor_parallel_size: int = 1,
                    null_vocab_size: Optional[int] = None):
    """Tokenizer with `padded_vocab_size` set. Knows NullTokenizer."""
    if tokenizer_type != "NullTokenizer":
        raise NotImplementedError(
            f"{tokenizer_type} tokenizer is not ported yet (it loads "
            f"vocabulary files; training slice)")
    tokenizer = _NullTokenizer(null_vocab_size or 0)
    tokenizer.padded_vocab_size = pad_vocab_size(
        tokenizer.vocab_size, make_vocab_size_divisible_by,
        tensor_parallel_size)
    return tokenizer
