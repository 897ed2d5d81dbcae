"""PyTorch port, the tokenizers and preprocess_data against the JAX
package's.

Every file-backed tokenizer is built from files written in-test: a tiny
GPT-2 BPE vocab and merges, a WordPiece vocab (lower-cased and cased),
and a `tokenizer.json` trained here with the `tokenizers` package. The
same texts give the same ids, detokenized strings, eod and padded
vocabulary sizes in both packages; SentencePiece refuses by name; and
the port's `preprocess_data` writes .bin/.idx files byte-identical to
`tools/preprocess_data.py`'s at 1 and 2 workers.
"""

import json
import os
import subprocess
import sys

import pytest

from megatron_llm_tpu.tokenizer import build_tokenizer as jax_build
from megatron_llm_tpu.tokenizer.gpt2_bpe import bytes_to_unicode
from megatron_llm_tpu_torch.tokenizer import build_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXTS = [
    "hello world",
    "Hello, world! hello   there.",
    "The quick brown fox jumps over the lazy dog.",
    "jumped, jumps; JUMPING fox-es 123 4567",
    "   leading and trailing spaces   ",
    "unicode: café naïve 東京",
    "",
]


@pytest.fixture
def gpt2_files(tmp_path):
    """A small real BPE: byte symbols plus merges building 'hello', ' w',
    'the' and ' the'."""
    b2u = bytes_to_unicode()
    base = [b2u[b] for b in range(256)]
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"),
              ("Ġ", "w"), ("t", "he"), ("Ġ", "the"), ("o", "r")]
    toks = base + ["he", "ll", "hell", "hello", "Ġw", "the", "Ġthe", "or",
                   "<|endoftext|>"]
    vf, mf = tmp_path / "vocab.json", tmp_path / "merges.txt"
    vf.write_text(json.dumps({t: i for i, t in enumerate(toks)}))
    mf.write_text("#version: 0.2\n" + "\n".join(f"{a} {b}"
                                                 for a, b in merges))
    return str(vf), str(mf)


@pytest.fixture
def wordpiece_vocab(tmp_path):
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "quick",
            "brown", "fox", "jump", "##s", "##ed", "##ing", ",", ".", "!",
            "hello", "world", "The", "Hello", "JUMP", "##ING", "-", "##es",
            "dog", "lazy", "over", "123"]
    f = tmp_path / "vocab.txt"
    f.write_text("\n".join(toks))
    return str(f)


@pytest.fixture
def hf_json(tmp_path):
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.BpeTrainer(vocab_size=180,
                                  special_tokens=["<unk>", "</s>"])
    tok.train_from_iterator(TEXTS * 4, trainer)
    path = tmp_path / "tokenizer.json"
    tok.save(str(path))
    return str(path)


def _pair(kind, files, **kw):
    return jax_build(kind, **files, **kw), build_tokenizer(kind, **files, **kw)


def _same(j, p, texts=TEXTS, roundtrip=True):
    assert p.vocab_size == j.vocab_size
    assert p.padded_vocab_size == j.padded_vocab_size
    assert p.eod == j.eod
    assert p.vocab == j.vocab
    for text in texts:
        ids = p.tokenize(text)
        assert ids == j.tokenize(text), text
        if roundtrip and ids:
            assert p.detokenize(ids) == j.detokenize(ids), text


@pytest.mark.parametrize("divisible,tp", [(128, 1), (8, 1), (128, 2)])
def test_gpt2_bpe(gpt2_files, divisible, tp):
    vf, mf = gpt2_files
    j, p = _pair("GPT2BPETokenizer", dict(vocab_file=vf, merges_file=mf),
                 make_vocab_size_divisible_by=divisible,
                 tensor_parallel_size=tp)
    _same(j, p)
    assert p.vocab["hello"] in p.tokenize("hello world")
    assert p.detokenize(p.tokenize(TEXTS[2])) == TEXTS[2]
    assert p.eod == p.vocab["<|endoftext|>"]


@pytest.mark.parametrize("kind", ["BertWordPieceLowerCase",
                                  "BertWordPieceCase"])
@pytest.mark.parametrize("extra_ids", [0, 3])
def test_wordpiece(wordpiece_vocab, kind, extra_ids):
    j, p = _pair(kind, dict(vocab_file=wordpiece_vocab),
                 vocab_extra_ids=extra_ids)
    _same(j, p)
    for name in ("cls", "sep", "pad", "mask", "bos_token_id",
                 "eos_token_id", "additional_special_tokens_ids"):
        assert getattr(p, name) == getattr(j, name), name
    if kind == "BertWordPieceLowerCase":
        assert p.detokenize(p.tokenize("The quick fox jumps.")) == \
            "the quick fox jumps ."


def test_hf_tokenizer_json(hf_json):
    for kind in ("HFTokenizer", "FalconTokenizer"):
        j, p = _pair(kind, dict(tokenizer_model=hf_json))
        _same(j, p)
        assert p.eod == p.vocab["</s>"]


@pytest.mark.parametrize("size", [0, 255, 31999, 50256])
def test_null(size):
    j, p = _pair("NullTokenizer", {}, null_vocab_size=size)
    _same(j, p, texts=["1 2 3", "7", ""], roundtrip=False)
    assert p.tokenize("12 7 3") == [12, 7, 3]
    assert p.detokenize([12, 7, 3]) == "12 7 3"
    assert p.eod == size


def test_llama2_null_vocab_pads_to_32000():
    assert build_tokenizer("NullTokenizer",
                           null_vocab_size=31999).padded_vocab_size == 32000


def test_sentencepiece_refuses_by_name(tmp_path):
    with pytest.raises(NotImplementedError,
                       match="SentencePieceTokenizer.*sentencepiece.*A3.2"):
        build_tokenizer("SentencePieceTokenizer",
                        tokenizer_model=str(tmp_path / "tokenizer.model"))
    with pytest.raises(NotImplementedError, match="NoSuchTokenizer"):
        build_tokenizer("NoSuchTokenizer")


def _run(cmd, env):
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("workers", [1, 2])
def test_preprocess_data_bytes_equal(tmp_path, gpt2_files, workers):
    """Both tools on one JSONL corpus (two keys, an empty document), the
    port as `python -m`, the JAX package's as its script."""
    vf, mf = gpt2_files
    corpus = tmp_path / "corpus.jsonl"
    with open(corpus, "w") as f:
        for i in range(60):
            text = TEXTS[i % len(TEXTS)] + f" doc {i}"
            f.write(json.dumps({"text": text if i % 17 else "",
                                "title": f"hello {i}"}) + "\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    common = ["--input", str(corpus), "--json_keys", "text", "title",
              "--tokenizer_type", "GPT2BPETokenizer", "--vocab_file", vf,
              "--merges_file", mf, "--append_eod", "--workers", str(workers),
              "--chunk_size", "4"]
    _run([sys.executable, "tools/preprocess_data.py", *common,
          "--output_prefix", str(tmp_path / "jax")], env)
    _run([sys.executable, "-m", "megatron_llm_tpu_torch.tools.preprocess_data",
          *common, "--output_prefix", str(tmp_path / "port")], env)
    for key in ("text", "title"):
        for ext in (".bin", ".idx"):
            a = (tmp_path / f"jax_{key}_document{ext}").read_bytes()
            b = (tmp_path / f"port_{key}_document{ext}").read_bytes()
            assert a == b and len(a) > 0, (key, ext)
