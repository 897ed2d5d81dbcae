"""Tokenize a JSONL corpus into the .bin/.idx mmap format (port of
tools/preprocess_data.py).

One document per line, its text under each of `--json_keys`; each key
gets `{output_prefix}_{key}_document.bin/.idx`, byte-identical to what
the JAX package's tool writes for the same input and flags.

    python -m megatron_llm_tpu_torch.tools.preprocess_data \\
        --input corpus.jsonl --output_prefix out \\
        --tokenizer_type GPT2BPETokenizer --vocab_file vocab.json \\
        --merges_file merges.txt --append_eod --workers 8

`--workers N` tokenizes in N spawned processes; documents keep their
order.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import time

import numpy as np

from megatron_llm_tpu_torch.data.indexed_dataset import (
    MMapIndexedDatasetBuilder,
    best_fitting_dtype,
)
from megatron_llm_tpu_torch.tokenizer import build_tokenizer

# set in each worker by _init_worker (and in the main process at
# --workers 1)
_TOKENIZER = None
_ARGS = None
_SPLITTER = None


def _build_splitter():
    """Sentence splitter for --split_sentences: nltk's punkt when it is
    installed with its data, else a punctuation-boundary regex."""
    try:
        import nltk

        try:
            nltk.sent_tokenize("probe. works.")
            print(" > sentence splitter: nltk punkt", flush=True)
            return nltk.sent_tokenize
        except LookupError:
            pass
    except ImportError:
        pass
    print(" > sentence splitter: regex (nltk/punkt unavailable); its "
          "boundaries differ from nltk's, so do not mix the corpora",
          flush=True)
    import re

    boundary = re.compile(r"(?<=[.!?])\s+(?=[A-Z0-9\"'(])")

    def split(text):
        return [s for s in boundary.split(text) if s.strip()]

    return split


def _tokenizer(args):
    return build_tokenizer(
        args.tokenizer_type, vocab_file=args.vocab_file,
        merges_file=args.merges_file, tokenizer_model=args.tokenizer_model,
        make_vocab_size_divisible_by=args.make_vocab_size_divisible_by,
        null_vocab_size=args.null_vocab_size)


def _init_worker(args):
    global _TOKENIZER, _ARGS, _SPLITTER
    _ARGS = args
    _TOKENIZER = _tokenizer(args)
    if args.split_sentences:
        _SPLITTER = _build_splitter()


def _encode(line: str):
    """(document, bytes read): the document maps each key to its list of
    id lists, one per sentence with --split_sentences, else one."""
    line = line.strip()
    if not line:
        return None, 0
    data = json.loads(line)
    out = {}
    for key in _ARGS.json_keys:
        text = data[key]
        if _ARGS.split_sentences:
            sent_ids = [ids for s in _SPLITTER(text)
                        if (ids := _TOKENIZER.tokenize(s))]
            if _ARGS.append_eod and sent_ids:
                sent_ids[-1].append(_TOKENIZER.eod)
            out[key] = sent_ids
        else:
            ids = _TOKENIZER.tokenize(text)
            if _ARGS.append_eod and len(ids) > 0:
                ids.append(_TOKENIZER.eod)
            out[key] = [ids] if ids else []
    return out, len(line)


def get_args(argv=None):
    p = argparse.ArgumentParser()
    g = p.add_argument_group("input data")
    g.add_argument("--input", type=str, required=True)
    g.add_argument("--json_keys", nargs="+", default=["text"])
    g = p.add_argument_group("tokenizer")
    g.add_argument("--tokenizer_type", type=str, required=True)
    g.add_argument("--vocab_file", type=str, default=None)
    g.add_argument("--merges_file", type=str, default=None)
    g.add_argument("--tokenizer_model", type=str, default=None)
    g.add_argument("--append_eod", action="store_true")
    g.add_argument("--split_sentences", action="store_true",
                   help="one indexed item per sentence (BERT/T5/ICT)")
    g.add_argument("--make_vocab_size_divisible_by", type=int, default=128)
    g.add_argument("--null_vocab_size", type=int, default=None)
    g = p.add_argument_group("output data")
    g.add_argument("--output_prefix", type=str, required=True)
    g.add_argument("--dataset_impl", type=str, default="mmap",
                   choices=["mmap"])
    g = p.add_argument_group("runtime")
    g.add_argument("--workers", type=int, default=1)
    g.add_argument("--chunk_size", type=int, default=25)
    g.add_argument("--log_interval", type=int, default=10000)
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    dtype = best_fitting_dtype(_tokenizer(args).padded_vocab_size)
    builders = {key: MMapIndexedDatasetBuilder(
        f"{args.output_prefix}_{key}_document.bin", dtype=dtype)
        for key in args.json_keys}

    start = time.time()
    total_bytes = 0
    n_docs = 0
    with open(args.input, encoding="utf-8") as fin, \
            contextlib.ExitStack() as stack:
        if args.workers > 1:
            # the pool is terminated on leaving the block, once every
            # document is read (or on an error)
            pool = stack.enter_context(
                multiprocessing.get_context("spawn").Pool(
                    args.workers, initializer=_init_worker,
                    initargs=(args,)))
            encoded = pool.imap(_encode, fin, args.chunk_size)
        else:
            _init_worker(args)
            encoded = map(_encode, fin)
        for doc, nbytes in encoded:
            if doc is None:
                continue
            total_bytes += nbytes
            for key, sentences in doc.items():
                if len(sentences) == 0:
                    continue
                for ids in sentences:
                    builders[key].add_item(np.asarray(ids))
                builders[key].end_document()
            n_docs += 1
            if n_docs % args.log_interval == 0:
                el = time.time() - start
                print(f"processed {n_docs} documents "
                      f"({n_docs / el:.1f} docs/s, "
                      f"{total_bytes / 1024 / 1024 / el:.2f} MB/s)",
                      flush=True)

    for key in args.json_keys:
        builders[key].finalize(f"{args.output_prefix}_{key}_document.idx")
    print(f"done: {n_docs} documents -> "
          f"{args.output_prefix}_*_document.bin/.idx", flush=True)


if __name__ == "__main__":
    main()
