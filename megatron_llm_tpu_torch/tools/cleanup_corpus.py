"""JSONL corpus cleanup: exact/near dedup + length and repetition filters
(port of tools/cleanup_corpus.py: the same filters and fingerprints, so
the output is byte-identical to the JAX package's tool's).

Parity target: the reference's openwebtext pipeline
(ref: tools/openwebtext/cleanup_dataset.py, find_duplicates.py,
remove_group_duplicates.py, filter_ngrams.py) compressed into one pass:

- unicode NFC normalization, keep one copy of exact duplicates
  (content hash over normalized lowercase text);
- near-dup removal by shingled MinHash-lite fingerprint (the reference
  uses LSH over url-grouped docs; here a 64-bit min-hash over word
  5-grams at a similarity threshold);
- drop documents shorter than --min_words or with a top-ngram repetition
  ratio above --max_repetition (filter_ngrams-style degenerate text).

  python -m megatron_llm_tpu_torch.tools.cleanup_corpus \
      --input raw.jsonl --output clean.jsonl \
      [--json_key text] [--min_words 128] [--near_dup_threshold 0.9]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import unicodedata
from collections import Counter


def _hash(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def _minhash(words, k: int = 5, n_perm: int = 16):
    """n_perm smallest 64-bit hashes over word k-grams."""
    if len(words) < k:
        return None
    hashes = sorted(
        int.from_bytes(
            hashlib.blake2b(" ".join(words[i:i + k]).encode(),
                            digest_size=8).digest(), "big")
        for i in range(len(words) - k + 1)
    )
    return tuple(hashes[:n_perm])


def _repetition_ratio(words, n: int = 3) -> float:
    if len(words) < n + 1:
        return 0.0
    grams = Counter(tuple(words[i:i + n]) for i in range(len(words) - n + 1))
    return grams.most_common(1)[0][1] / max(len(words) - n + 1, 1)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--json_key", default="text")
    p.add_argument("--min_words", type=int, default=128)
    p.add_argument("--max_repetition", type=float, default=0.2)
    p.add_argument("--near_dup_threshold", type=float, default=0.9,
                   help="fingerprint overlap fraction treated as duplicate")
    args = p.parse_args(argv)

    seen_exact = set()
    fingerprints = []  # list of frozensets
    buckets = {}  # individual min-hash value -> fingerprint indices
    stats = Counter()
    with open(args.input, encoding="utf-8") as fin, \
            open(args.output, "w", encoding="utf-8") as fout:
        for line in fin:
            line = line.strip()
            if not line:
                continue
            stats["total"] += 1
            try:
                doc = json.loads(line)
                text = unicodedata.normalize("NFC", doc[args.json_key])
            except (json.JSONDecodeError, KeyError, TypeError):
                stats["malformed"] += 1
                continue
            words = text.split()
            if len(words) < args.min_words:
                stats["too_short"] += 1
                continue
            if _repetition_ratio(words) > args.max_repetition:
                stats["repetitive"] += 1
                continue
            h = _hash(text.lower())
            if h in seen_exact:
                stats["exact_dup"] += 1
                continue
            seen_exact.add(h)
            fp = _minhash(words)
            if fp is not None:
                fps = frozenset(fp)
                # LSH-style bucketing (ref find_duplicates.py): only
                # fingerprints sharing at least one min-hash are compared,
                # keeping the pass near-linear in corpus size
                candidates = set()
                for h64 in fps:
                    candidates.update(buckets.get(h64, ()))
                is_dup = any(
                    len(fps & fingerprints[c]) / len(fp)
                    >= args.near_dup_threshold
                    for c in candidates
                )
                if is_dup:
                    stats["near_dup"] += 1
                    continue
                idx = len(fingerprints)
                fingerprints.append(fps)
                for h64 in fps:
                    buckets.setdefault(h64, []).append(idx)
            doc[args.json_key] = text
            fout.write(json.dumps(doc, ensure_ascii=False) + "\n")
            stats["kept"] += 1

    print(" | ".join(f"{k}: {v}" for k, v in sorted(stats.items())),
          flush=True)


if __name__ == "__main__":
    main()
