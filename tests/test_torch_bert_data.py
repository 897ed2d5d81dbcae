"""PyTorch port, the encoder family's data path against the JAX
package's, on the CPU:

- `build_mapping` (the port's g++ helpers) equal to the JAX helper's bit
  for bit, across short-sequence probabilities, sentence minimums,
  epochs and sample caps;
- `create_masked_lm_predictions` equal field for field from the same
  RandomState, in BERT and T5 styles, whole-word and not, geometric
  spans and favoured long n-grams;
- `BertDataset` samples equal field for field, with and without the
  binary head, over the document-range splits of
  `build_train_valid_test_datasets`, each package reading the other's
  cached sample map;
- the loader's dict batches (`keys=`) equal to the JAX loader's.
"""

import os

import numpy as np
import pytest

from megatron_llm_tpu.data import helpers as jax_helpers
from megatron_llm_tpu.data import indexed_dataset as jax_idx
from megatron_llm_tpu.data import masked_lm as jax_mlm
from megatron_llm_tpu.data.data_samplers import (
    build_pretraining_data_loader as jax_loader,
)
from megatron_llm_tpu.data.dataset_utils import (
    build_train_valid_test_datasets as jax_build,
)
from megatron_llm_tpu.tokenizer import build_tokenizer as jax_tokenizer
from megatron_llm_tpu_torch.data import helpers, masked_lm
from megatron_llm_tpu_torch.data.data_samplers import (
    build_pretraining_data_loader,
)
from megatron_llm_tpu_torch.data.dataset_utils import (
    build_train_valid_test_datasets,
)
from megatron_llm_tpu_torch.pretrain_bert import BERT_KEYS
from megatron_llm_tpu_torch.tokenizer import build_tokenizer

from torch_parity import jax_native_helpers


@pytest.fixture(autouse=True)
def _jax_helpers_loaded():
    """The JAX native helpers loaded in this worker, where a concurrent
    rebuild of a stale library left a failed load behind
    (torch_parity.jax_native_helpers)."""
    jax_native_helpers()


def sentence_corpus(seed, n_docs=120, long_every=0):
    rs = np.random.RandomState(seed)
    counts = rs.randint(1, 8, n_docs)
    docs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    sizes = rs.randint(1, 60, int(docs[-1])).astype(np.int32)
    if long_every:
        sizes[::long_every] = 600  # past the long-sentence cut
    return docs, sizes


@pytest.mark.parametrize("short_seq_prob", [0.0, 0.1, 0.33])
@pytest.mark.parametrize("min_num_sent", [1, 2])
@pytest.mark.parametrize("epochs,cap", [(1, 2 ** 62), (3, 2 ** 62),
                                        (5, 150)])
def test_build_mapping_equals_the_jax_helper(short_seq_prob, min_num_sent,
                                             epochs, cap):
    docs, sizes = sentence_corpus(int(short_seq_prob * 100) + min_num_sent,
                                  long_every=37)
    args = (docs, sizes, epochs, cap, 125, short_seq_prob, 1234,
            min_num_sent)
    got = helpers.build_mapping(*args)
    want = jax_helpers.build_mapping(*args)
    assert got.dtype == want.dtype == np.int64 and got.shape[1] == 3
    assert len(got) > 50
    np.testing.assert_array_equal(got, want)


def vocab_and_inv(n_words=50, n_pieces=20):
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"w{i}" for i in range(n_words)] + [
        f"##p{i}" for i in range(n_pieces)]
    inv = dict(enumerate(toks))
    return list(inv), inv


@pytest.mark.parametrize("kw", [
    dict(),
    dict(do_whole_word_mask=False),
    dict(geometric_dist=True, max_ngrams=5),
    dict(favor_longer_ngram=True),
    dict(masking_style="t5", geometric_dist=True, max_ngrams=10),
    dict(masked_lm_prob=0.0),
], ids=["bert", "no_whole_word", "geometric", "favor_longer", "t5",
        "prob0"])
def test_masked_lm_predictions_equal_the_jax_draws(kw):
    ids, inv = vocab_and_inv()
    kw = dict(kw)
    prob = kw.pop("masked_lm_prob", 0.15)
    for seed in range(20):
        rs = np.random.RandomState(seed)
        tokens = [2] + list(rs.randint(5, len(ids), rs.randint(8, 120))) \
            + [3]
        outs = []
        for mod in (masked_lm, jax_mlm):
            rng = np.random.RandomState(100 + seed)
            outs.append(mod.create_masked_lm_predictions(
                list(tokens), ids, inv, prob, 2, 3, 4,
                max(1, int(prob * len(tokens))), rng, **kw)
                + (rng.randint(0, 1 << 30),))
        assert outs[0] == outs[1]


def test_segments_truncation_and_padding_equal_the_jax_helpers():
    rs = np.random.RandomState(3)
    for seed in range(30):
        sample = [list(rs.randint(5, 70, rs.randint(1, 20)))
                  for _ in range(rs.randint(2, 6))]
        got, want = [], []
        for mod, out in ((masked_lm, got), (jax_mlm, want)):
            rng = np.random.RandomState(seed)
            a, b, rand = mod.get_a_and_b_segments(sample, rng)
            a, b = list(a), list(b)
            trunc = mod.truncate_segments(a, b, len(a), len(b), 25, rng)
            toks, types = mod.create_tokens_and_tokentypes(a, b, 2, 3)
            padded = mod.pad_and_convert_to_numpy(
                toks, types, [1, 4], [9, 10], 0, 40)
            out.append((rand, trunc, toks, types,
                        [x.tolist() for x in padded]))
        assert got == want


def write_corpus(tmp_path, seed=0, n_docs=80):
    """A WordPiece vocabulary and a sentence-split corpus from the JAX
    package's builder: (vocab path, corpus prefix)."""
    ids, inv = vocab_and_inv(80, 30)
    vpath = tmp_path / "vocab.txt"
    vpath.write_text("\n".join(inv[i] for i in ids) + "\n")
    rs = np.random.RandomState(seed)
    prefix = str(tmp_path / "c_text_sentence")
    b = jax_idx.MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    for _ in range(n_docs):
        for _ in range(rs.randint(1, 7)):
            b.add_item(rs.randint(5, len(ids), rs.randint(2, 30)))
        b.end_document()
    b.finalize(prefix + ".idx")
    return str(vpath), prefix


@pytest.mark.parametrize("binary_head", [True, False])
@pytest.mark.parametrize("first", ["port", "jax"])
def test_bert_dataset_samples_equal_the_jax_samples(tmp_path, binary_head,
                                                    first):
    """Field for field over every split; whichever package builds the
    sample map first, the other reads its cache."""
    vocab, prefix = write_corpus(tmp_path, seed=int(binary_head))
    ptok = build_tokenizer("BertWordPieceLowerCase", vocab_file=vocab)
    jtok = jax_tokenizer("BertWordPieceLowerCase", vocab_file=vocab)
    args = ("80,10,10", [300, 40, 30], 64, 0.15, 0.1, 17)
    build = {"port": lambda: build_train_valid_test_datasets(
                 prefix, *args, ptok, binary_head=binary_head),
             "jax": lambda: jax_build(prefix, *args, jtok,
                                      binary_head=binary_head)}
    a = build[first]()
    caches = sorted(f for f in os.listdir(tmp_path) if "indexmap" in f)
    b = build["jax" if first == "port" else "port"]()
    assert sorted(f for f in os.listdir(tmp_path)
                  if "indexmap" in f) == caches and len(caches) == 3
    port, jax_ = (a, b) if first == "port" else (b, a)
    for p, j in zip(port, jax_):
        assert len(p) == len(j) > 0
        np.testing.assert_array_equal(np.asarray(p.samples_mapping),
                                      np.asarray(j.samples_mapping))
        for i in range(len(p)):
            ps, js = p[i], j[i]
            assert set(ps) == set(js)
            for k in js:
                np.testing.assert_array_equal(ps[k], js[k], err_msg=k)
    # masked positions exist and the types mark the second segment
    s = port[0][0]
    assert s["loss_mask"].sum() > 0
    assert (s["types"].max() == 1) == binary_head


def test_dict_batches_equal_the_jax_loader(tmp_path):
    vocab, prefix = write_corpus(tmp_path, seed=5)
    ptok = build_tokenizer("BertWordPieceLowerCase", vocab_file=vocab)
    jtok = jax_tokenizer("BertWordPieceLowerCase", vocab_file=vocab)
    args = ("100,0,0", [64, 0, 0], 48, 0.15, 0.1, 3)
    pds = build_train_valid_test_datasets(prefix, *args, ptok)[0]
    jds = jax_build(prefix, *args, jtok)[0]
    for consumed in (0, 12):
        pl = iter(build_pretraining_data_loader(pds, consumed, 3, 2, 2,
                                                keys=BERT_KEYS))
        jl = iter(jax_loader(jds, consumed, 3, 2, 2, keys=BERT_KEYS))
        for _ in range(3):
            pb, jb = next(pl), next(jl)
            assert list(pb) == list(jb) == BERT_KEYS
            for k in BERT_KEYS:
                assert pb[k].dtype == np.int32
                assert pb[k].shape[:2] == (2, 6)
                np.testing.assert_array_equal(pb[k], jb[k])
