"""PyTorch port, the corpus tools against the JAX package's on the CPU.

`megatron_llm_tpu_torch/tools/cleanup_corpus.py` writes a cleaned JSONL
byte for byte the JAX tool's (`tools/cleanup_corpus.py`) on a seeded
corpus with exact and near duplicates, short, repetitive, malformed and
non-NFC documents, under three sets of options; and
`megatron_llm_tpu_torch/tools/merge_datasets.py` merges indexed datasets
written by the port's `preprocess_data` into .bin/.idx files byte for
byte the JAX tool's (`tools/merge_datasets.py`).
"""

import importlib.util
import json
import os
import subprocess
import sys
import unicodedata

import numpy as np
import pytest

from megatron_llm_tpu_torch.data.indexed_dataset import MMapIndexedDataset
from megatron_llm_tpu_torch.tools import (
    cleanup_corpus,
    merge_datasets,
    preprocess_data,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _words(rs, n, vocab):
    return [vocab[i] for i in rs.randint(0, len(vocab), n)]


def _write_raw_corpus(path, seed):
    """JSONL lines: plain documents, exact duplicates (case changed),
    near duplicates (one word changed), short documents, repetitive
    ones, malformed lines, a missing key, an empty line, and decomposed
    unicode that NFC composes."""
    rs = np.random.RandomState(seed)
    vocab = [f"w{i}" for i in range(400)] + ["café", "naıve",
                                            "été", "Zoë"]
    docs = []
    lines = []
    for i in range(120):
        kind = rs.randint(0, 10)
        if kind == 0 and docs:
            lines.append(json.dumps({"text": docs[rs.randint(len(docs))]
                                     .upper(), "id": i}))
        elif kind == 1 and docs:
            w = docs[rs.randint(len(docs))].split()
            w[rs.randint(len(w))] = "changed"
            lines.append(json.dumps({"text": " ".join(w), "id": i}))
        elif kind == 2:
            lines.append(json.dumps({"text": " ".join(
                _words(rs, rs.randint(3, 30), vocab)), "id": i}))
        elif kind == 3:
            lines.append(json.dumps({"text": " ".join(
                ["again and again"] * rs.randint(20, 60)), "id": i}))
        elif kind == 4:
            lines.append(rs.choice(["{not json", json.dumps({"body": "x"}),
                                    json.dumps({"text": 7}), ""]))
        else:
            text = " ".join(_words(rs, rs.randint(40, 200), vocab))
            docs.append(text)
            lines.append(json.dumps({"text": text, "id": i},
                                    ensure_ascii=bool(i % 2)))
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("opts", [
    [],
    ["--min_words", "20", "--near_dup_threshold", "0.5"],
    ["--min_words", "10", "--max_repetition", "0.5",
     "--near_dup_threshold", "1.0"],
], ids=["defaults", "short_docs_loose_dups", "loose_filters"])
def test_cleanup_corpus_bytes_equal(tmp_path, opts, capsys):
    raw = tmp_path / "raw.jsonl"
    _write_raw_corpus(raw, seed=len(opts) + 3)
    jax_tool = _jax_tool("cleanup_corpus")
    jax_tool.main(["--input", str(raw), "--output",
                   str(tmp_path / "jax.jsonl"), *opts])
    jax_stats = capsys.readouterr().out
    cleanup_corpus.main(["--input", str(raw), "--output",
                         str(tmp_path / "port.jsonl"), *opts])
    port_stats = capsys.readouterr().out
    a = (tmp_path / "jax.jsonl").read_bytes()
    b = (tmp_path / "port.jsonl").read_bytes()
    assert a == b
    assert port_stats == jax_stats
    # the corpus exercises the filters: something kept, something cut
    assert "kept" in port_stats and "malformed" in port_stats
    kept = [json.loads(x)["text"] for x in b.decode().splitlines()]
    assert kept and all(unicodedata.is_normalized("NFC", t) for t in kept)


def _indexed_dataset(tmp_path, name, seed, n_docs):
    rs = np.random.RandomState(seed)
    jsonl = tmp_path / f"{name}.jsonl"
    with open(jsonl, "w") as f:
        for _ in range(n_docs):
            ids = rs.randint(0, 255, rs.randint(1, 40))
            f.write(json.dumps({"text": " ".join(map(str, ids))}) + "\n")
    out = tmp_path / "datasets" / name
    out.parent.mkdir(exist_ok=True)
    preprocess_data.main([
        "--input", str(jsonl), "--output_prefix", str(out),
        "--tokenizer_type", "NullTokenizer", "--null_vocab_size", "255",
        "--append_eod", "--workers", "1"])
    return str(out) + "_text_document"


def test_merge_datasets_bytes_equal(tmp_path):
    """Two corpora through the port's preprocess_data, merged by both
    tools (the port's as `python -m`): identical .bin and .idx, and the
    merged dataset reads back as the two in order."""
    parts = [_indexed_dataset(tmp_path, "b_part", 1, 37),
             _indexed_dataset(tmp_path, "a_part", 2, 23)]
    src = str(tmp_path / "datasets")
    _jax_tool("merge_datasets").main(
        ["--input", src, "--output_prefix", str(tmp_path / "jax")])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "megatron_llm_tpu_torch.tools.merge_datasets",
         "--input", src, "--output_prefix", str(tmp_path / "port")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    for ext in (".bin", ".idx"):
        a = (tmp_path / f"jax{ext}").read_bytes()
        b = (tmp_path / f"port{ext}").read_bytes()
        assert a == b and len(a) > 0, ext
    merged = MMapIndexedDataset(str(tmp_path / "port"))
    want = []
    for prefix in sorted(parts):  # the tools merge in prefix order
        ds = MMapIndexedDataset(prefix)
        want += [np.array(ds[i]) for i in range(len(ds))]
        ds.close()
    assert len(merged) == len(want) == 60
    assert all(np.array_equal(merged[i], w) for i, w in enumerate(want))
    merged.close()


def test_merge_datasets_refuses_an_empty_directory(tmp_path):
    with pytest.raises(SystemExit, match="no .bin/.idx pairs"):
        merge_datasets.main(["--input", str(tmp_path), "--output_prefix",
                             str(tmp_path / "out")])
