"""Tokenizers (port of tokenizer/tokenizer.py).

`build_tokenizer` dispatches on the type name as the JAX package does and
pads the vocabulary to a multiple of `make_vocab_size_divisible_by * tp`
(`padded_vocab_size`). Every tokenizer loads local files only:

- GPT2BPETokenizer: vocab.json + merges.txt (`tokenizer/gpt2_bpe.py`);
- BertWordPieceLowerCase / BertWordPieceCase: a WordPiece vocab.txt;
- HFTokenizer / FalconTokenizer: a `tokenizer.json` (the `tokenizers`
  package) or a pretrained directory (`transformers`), both imported
  when such a tokenizer is built;
- NullTokenizer: integer pass-through, its last id eod.

SentencePieceTokenizer (Llama's) raises: it needs a `tokenizer.model`
file and the `sentencepiece` package (ROADMAP.md A3.2).
"""

from __future__ import annotations

import os
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
    def cls(self):
        raise NotImplementedError

    @property
    def sep(self):
        raise NotImplementedError

    @property
    def pad(self):
        raise NotImplementedError

    @property
    def eod(self):
        raise NotImplementedError

    @property
    def mask(self):
        raise NotImplementedError


class _GPT2BPETokenizer(AbstractTokenizer):
    """GPT-2 byte-level BPE from vocab.json + merges.txt."""

    def __init__(self, vocab_file: str, merges_file: str):
        super().__init__("GPT2 BPE")
        from megatron_llm_tpu_torch.tokenizer.gpt2_bpe import GPT2BPE

        self.tokenizer = GPT2BPE(vocab_file, merges_file)
        self.eod_id = self.tokenizer.encoder["<|endoftext|>"]

    @property
    def vocab_size(self):
        return len(self.tokenizer.encoder)

    @property
    def vocab(self):
        return self.tokenizer.encoder

    @property
    def inv_vocab(self):
        return self.tokenizer.decoder

    def tokenize(self, text):
        return self.tokenizer.encode(text)

    def detokenize(self, token_ids):
        return self.tokenizer.decode(token_ids)

    @property
    def eod(self):
        return self.eod_id


class _HFTokenizer(AbstractTokenizer):
    """A local `tokenizer.json` (through `tokenizers`) or a local
    pretrained directory (through `transformers`), each imported here,
    when the tokenizer is built."""

    def __init__(self, path: str, name: str = "HFTokenizer"):
        super().__init__(name)
        if os.path.isdir(path):
            from transformers import AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(path, local_files_only=True)
            self._encode = lambda t: self.tokenizer(t)["input_ids"]
            self._decode = self.tokenizer.decode
            self._size = len(self.tokenizer)
            self._vocab = self.tokenizer.get_vocab()
            self._eod = self.tokenizer.eos_token_id
        else:
            from tokenizers import Tokenizer

            self.tokenizer = Tokenizer.from_file(path)
            self._encode = lambda t: self.tokenizer.encode(t).ids
            self._decode = self.tokenizer.decode
            self._size = self.tokenizer.get_vocab_size()
            self._vocab = self.tokenizer.get_vocab()
            eos = None
            for cand in ("</s>", "<|endoftext|>", "<|end_of_text|>"):
                if cand in self._vocab:
                    eos = self._vocab[cand]
                    break
            self._eod = eos
        self._inv_vocab = {v: k for k, v in self._vocab.items()}

    @property
    def vocab_size(self):
        return self._size

    @property
    def vocab(self):
        return self._vocab

    @property
    def inv_vocab(self):
        return self._inv_vocab

    def tokenize(self, text):
        return self._encode(text)

    def detokenize(self, token_ids):
        return self._decode([int(t) for t in token_ids])

    @property
    def eod(self):
        return self._eod


class _FalconTokenizer(_HFTokenizer):
    """Falcon's HF tokenizer from a local directory or tokenizer.json."""

    def __init__(self, path: str):
        super().__init__(path, name="FalconTokenizer")


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


def build_tokenizer(tokenizer_type: str, vocab_file: Optional[str] = None,
                    merges_file: Optional[str] = None,
                    tokenizer_model: Optional[str] = None,
                    make_vocab_size_divisible_by: int = 128,
                    tensor_parallel_size: int = 1,
                    null_vocab_size: Optional[int] = None,
                    vocab_extra_ids: int = 0):
    """The tokenizer of `tokenizer_type` with `padded_vocab_size` set."""
    if tokenizer_type == "GPT2BPETokenizer":
        if not (vocab_file and merges_file):
            raise ValueError("GPT2BPETokenizer needs --vocab_file and "
                             "--merges_file")
        tokenizer = _GPT2BPETokenizer(vocab_file, merges_file)
    elif tokenizer_type == "SentencePieceTokenizer":
        raise NotImplementedError(
            "SentencePieceTokenizer is not ported yet: it needs a "
            "tokenizer.model file and the sentencepiece package, which "
            "neither environment has (ROADMAP.md A3.2)")
    elif tokenizer_type == "FalconTokenizer":
        tokenizer = _FalconTokenizer(tokenizer_model or vocab_file)
    elif tokenizer_type == "HFTokenizer":
        tokenizer = _HFTokenizer(tokenizer_model or vocab_file)
    elif tokenizer_type == "BertWordPieceLowerCase":
        tokenizer = _BertWordPieceTokenizer(vocab_file, lower_case=True,
                                            vocab_extra_ids=vocab_extra_ids)
    elif tokenizer_type == "BertWordPieceCase":
        tokenizer = _BertWordPieceTokenizer(vocab_file, lower_case=False,
                                            vocab_extra_ids=vocab_extra_ids)
    elif tokenizer_type == "NullTokenizer":
        tokenizer = _NullTokenizer(null_vocab_size or 0)
    else:
        raise NotImplementedError(
            f"{tokenizer_type} tokenizer is not implemented")
    tokenizer.padded_vocab_size = pad_vocab_size(
        tokenizer.vocab_size, make_vocab_size_divisible_by,
        tensor_parallel_size)
    return tokenizer


class _BertWordPieceTokenizer(AbstractTokenizer):
    """BERT WordPiece: a whitespace and punctuation split, then greedy
    longest-match word pieces."""

    def __init__(self, vocab_file: str, lower_case: bool = True,
                 vocab_extra_ids: int = 0):
        super().__init__(
            "BERT Lower Case" if lower_case else "BERT Upper Case"
        )
        self.lower_case = lower_case
        self._vocab = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    self._vocab[tok] = i
        self.cls_id = self._vocab["[CLS]"]
        self.sep_id = self._vocab["[SEP]"]
        self.pad_id = self._vocab["[PAD]"]
        self.mask_id = self._vocab["[MASK]"]
        self.unk_id = self._vocab.get("[UNK]", 0)
        # [BOS]/[EOS] + <extra_id_N> sentinels for T5 span corruption
        for tok in ("[BOS]", "[EOS]"):
            self._vocab.setdefault(tok, len(self._vocab))
        self._bos_token_id = self._vocab["[BOS]"]
        self._eos_token_id = self._vocab["[EOS]"]
        self._additional_special_tokens_ids = []
        for i in range(vocab_extra_ids):
            tok = f"<extra_id_{i}>"
            self._vocab.setdefault(tok, len(self._vocab))
            self._additional_special_tokens_ids.append(self._vocab[tok])
        self._inv = {v: k for k, v in self._vocab.items()}

    # -- basic tokenization ------------------------------------------------
    @staticmethod
    def _is_punct(ch):
        import unicodedata

        cp = ord(ch)
        if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
            return True
        return unicodedata.category(ch).startswith("P")

    def _basic_tokenize(self, text: str):
        if self.lower_case:
            text = text.lower()
        out, cur = [], []
        for ch in text:
            if ch.isspace():
                if cur:
                    out.append("".join(cur))
                    cur = []
            elif self._is_punct(ch):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
        return out

    def _wordpiece(self, word: str):
        if len(word) > 200:
            return [self.unk_id]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            cur_id = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self._vocab:
                    cur_id = self._vocab[sub]
                    break
                end -= 1
            if cur_id is None:
                return [self.unk_id]
            pieces.append(cur_id)
            start = end
        return pieces

    @property
    def vocab_size(self):
        return len(self._vocab)

    @property
    def vocab(self):
        return self._vocab

    @property
    def inv_vocab(self):
        return self._inv

    def tokenize(self, text):
        ids = []
        for word in self._basic_tokenize(text):
            ids.extend(self._wordpiece(word))
        return ids

    def detokenize(self, token_ids):
        toks = [self._inv[int(i)] for i in token_ids]
        out = []
        for t in toks:
            if t.startswith("##") and out:
                out[-1] = out[-1] + t[2:]
            else:
                out.append(t)
        return " ".join(out)

    @property
    def cls(self):
        return self.cls_id

    @property
    def sep(self):
        return self.sep_id

    @property
    def pad(self):
        return self.pad_id

    @property
    def mask(self):
        return self.mask_id

    @property
    def eod(self):
        return self.sep_id

    @property
    def bos_token_id(self):
        return self._bos_token_id

    @property
    def eos_token_id(self):
        return self._eos_token_id

    @property
    def additional_special_tokens_ids(self):
        return self._additional_special_tokens_ids
