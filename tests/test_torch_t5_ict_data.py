"""PyTorch port, the T5 and ICT data paths against the JAX package's, on
the CPU:

- `build_blocks_mapping` (the port's g++ helpers) equal to the JAX
  helper's bit for bit, with and without one-sentence blocks, across
  epochs, sample caps and title lengths;
- `T5Dataset` samples equal field for field over the document-range
  splits of `build_train_valid_test_datasets(dataset_type="t5")`, each
  package reading the other's cached sample map;
- `ICTDataset` samples equal field for field when both packages draw in
  the same order (in order, in a scattered order, and across
  `query_in_block_prob`, titles and one-sentence documents), each
  reading the other's cached block map; `get_block` and
  `get_null_block` equal;
- the loader's T5 and ICT dict batches equal to the JAX loader's, the
  ICT loader drawing the dataset's stream in the same order;
- the sentinel, [BOS] and [EOS] ids and the padded vocabulary equal to
  the JAX tokenizer's on the same vocabulary file.
"""

import os

import numpy as np
import pytest

from megatron_llm_tpu.data import helpers as jax_helpers
from megatron_llm_tpu.data import indexed_dataset as jax_idx
from megatron_llm_tpu.data.data_samplers import (
    build_pretraining_data_loader as jax_loader,
)
from megatron_llm_tpu.data.dataset_utils import (
    build_train_valid_test_datasets as jax_build,
)
from megatron_llm_tpu.data.ict_dataset import ICTDataset as JaxICT
from megatron_llm_tpu.tokenizer import build_tokenizer as jax_tokenizer
from megatron_llm_tpu_torch.data import helpers
from megatron_llm_tpu_torch.data.data_samplers import (
    build_pretraining_data_loader,
)
from megatron_llm_tpu_torch.data.dataset_utils import (
    build_train_valid_test_datasets,
)
from megatron_llm_tpu_torch.data.ict_dataset import ICTDataset
from megatron_llm_tpu_torch.data.indexed_dataset import make_dataset
from megatron_llm_tpu_torch.pretrain_ict import ICT_KEYS
from megatron_llm_tpu_torch.pretrain_t5 import T5_KEYS
from megatron_llm_tpu_torch.tokenizer import build_tokenizer

from torch_parity import jax_native_helpers


@pytest.fixture(autouse=True)
def _jax_helpers_loaded():
    """The JAX native helpers loaded in this worker, where a concurrent
    rebuild of a stale library left a failed load behind
    (torch_parity.jax_native_helpers)."""
    jax_native_helpers()


def block_corpus(seed, n_docs=150, long_every=0):
    rs = np.random.RandomState(seed)
    counts = rs.randint(1, 9, n_docs)
    docs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    sizes = rs.randint(1, 40, int(docs[-1])).astype(np.int32)
    if long_every:
        sizes[::long_every] = 600  # past the long-sentence cut
    titles = rs.randint(1, 12, n_docs).astype(np.int32)
    return docs, sizes, titles


@pytest.mark.parametrize("one_sent", [False, True])
@pytest.mark.parametrize("epochs,cap", [(1, 2 ** 62), (3, 2 ** 62),
                                        (4, 150)])
def test_build_blocks_mapping_equals_the_jax_helper(one_sent, epochs, cap):
    docs, sizes, titles = block_corpus(epochs + 10 * one_sent,
                                       long_every=41)
    args = (docs, sizes, titles, epochs, cap, 93, 4321)
    got = helpers.build_blocks_mapping(*args, use_one_sent_blocks=one_sent)
    want = jax_helpers.build_blocks_mapping(*args,
                                            use_one_sent_blocks=one_sent)
    assert got.dtype == want.dtype == np.int64 and got.shape[1] == 4
    assert len(got) > 100
    np.testing.assert_array_equal(got, want)
    # one-sentence blocks come only under use_one_sent_blocks
    assert (got[:, 1] - got[:, 0]).min() == (1 if one_sent else 2)


def write_vocab(tmp_path, n_words=80, n_pieces=30):
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"w{i}" for i in range(n_words)] + [
        f"##p{i}" for i in range(n_pieces)]
    vpath = tmp_path / "vocab.txt"
    vpath.write_text("\n".join(toks) + "\n")
    return str(vpath), len(toks)


def write_corpus(tmp_path, seed=0, n_docs=80, lo=2, hi=7, name="c"):
    """A sentence-split corpus and a titles corpus (one item a
    document) from the JAX package's builder: (vocab path, corpus
    prefix, titles prefix)."""
    vocab, n = write_vocab(tmp_path)
    rs = np.random.RandomState(seed)
    prefix = str(tmp_path / f"{name}_text_sentence")
    titles = str(tmp_path / f"{name}_titles_document")
    b = jax_idx.MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    t = jax_idx.MMapIndexedDatasetBuilder(titles + ".bin", dtype=np.uint16)
    for _ in range(n_docs):
        for _ in range(rs.randint(lo, hi)):
            b.add_item(rs.randint(5, n, rs.randint(2, 30)))
        b.end_document()
        t.add_item(rs.randint(5, n, rs.randint(1, 6)))
        t.end_document()
    b.finalize(prefix + ".idx")
    t.finalize(titles + ".idx")
    return vocab, prefix, titles


def tokenizers(vocab, extra=100):
    return (build_tokenizer("BertWordPieceLowerCase", vocab_file=vocab,
                            vocab_extra_ids=extra),
            jax_tokenizer("BertWordPieceLowerCase", vocab_file=vocab,
                          vocab_extra_ids=extra))


def same_samples(p, j, order):
    for i in order:
        ps, js = p[i], j[i]
        assert set(ps) == set(js)
        for k in js:
            np.testing.assert_array_equal(ps[k], js[k], err_msg=k)


@pytest.mark.parametrize("first", ["port", "jax"])
def test_t5_dataset_samples_equal_the_jax_samples(tmp_path, first):
    """Field for field over every split; whichever package builds the
    sample map first, the other reads its cache."""
    vocab, prefix, _ = write_corpus(tmp_path, seed=3)
    ptok, jtok = tokenizers(vocab)
    args = ("80,10,10", [300, 40, 30], 64, 0.15, 0.1, 17)
    build = {"port": lambda: build_train_valid_test_datasets(
                 prefix, *args, ptok, dataset_type="t5",
                 max_seq_length_dec=40),
             "jax": lambda: jax_build(prefix, *args, jtok,
                                      dataset_type="t5",
                                      max_seq_length_dec=40)}
    a = build[first]()
    caches = sorted(f for f in os.listdir(tmp_path) if "indexmap" in f)
    b = build["jax" if first == "port" else "port"]()
    assert sorted(f for f in os.listdir(tmp_path)
                  if "indexmap" in f) == caches and len(caches) == 3
    port, jax_ = (a, b) if first == "port" else (b, a)
    for p, j in zip(port, jax_):
        assert type(p).__name__ == "T5Dataset"
        assert len(p) == len(j) > 0
        np.testing.assert_array_equal(np.asarray(p.samples_mapping),
                                      np.asarray(j.samples_mapping))
        same_samples(p, j, range(len(p)))
    # spans become sentinels: the decoder starts with [BOS], the labels
    # end with [EOS], and every label row holds a sentinel
    s = port[0][0]
    assert s["text_dec"][0] == ptok.bos_token_id
    n_dec = int(s["dec_mask"].sum())
    assert s["labels"][n_dec - 1] == ptok.eos_token_id
    assert set(s["labels"][:n_dec]) & set(ptok.additional_special_tokens_ids)


def ict_pair(tmp_path, seed=0, one_sent=False, **kw):
    lo = 1 if one_sent else 2
    vocab, prefix, titles = write_corpus(tmp_path, seed=seed, lo=lo)
    ptok, jtok = tokenizers(vocab, extra=0)
    blocks, tds = make_dataset(prefix), make_dataset(titles)
    common = dict(name="train", data_prefix=prefix, num_epochs=None,
                  max_num_samples=200, max_seq_length=48, seed=11,
                  use_one_sent_docs=one_sent, **kw)
    p = ICTDataset(block_dataset=blocks, title_dataset=tds, tokenizer=ptok,
                   **common)
    j = JaxICT(block_dataset=jax_idx.make_dataset(prefix, "mmap"),
               title_dataset=jax_idx.make_dataset(titles, "mmap"),
               tokenizer=jtok, **common)
    return p, j, prefix


@pytest.mark.parametrize("kw", [
    dict(query_in_block_prob=0.1),
    dict(query_in_block_prob=1.0),
    dict(query_in_block_prob=0.5, use_titles=False),
    dict(query_in_block_prob=0.3, one_sent=True),
])
@pytest.mark.parametrize("order", ["in_order", "scattered"])
def test_ict_samples_equal_the_jax_samples(tmp_path, kw, order):
    """The two datasets' streams stay in step when read in the same
    order, whatever the order."""
    kw = dict(kw)
    p, j, prefix = ict_pair(tmp_path, seed=len(kw), one_sent=kw.pop(
        "one_sent", False), **kw)
    assert len(p) == len(j) > 100
    np.testing.assert_array_equal(np.asarray(p.samples_mapping),
                                  np.asarray(j.samples_mapping))
    idx = np.arange(len(p))
    if order == "scattered":
        idx = np.random.RandomState(4).permutation(idx)[:120]
        idx = np.concatenate([idx, idx[:10]])  # a sample read again
    same_samples(p, j, idx)
    # one cached block map, read by the second package
    assert len([f for f in os.listdir(os.path.dirname(prefix))
                if "_ict_indexmap" in f]) == 1


def test_ict_stream_depends_on_what_was_read_before(tmp_path):
    """A sample is a function of the reads before it, in both packages:
    a dataset that skipped samples 0-39 draws samples 40-59 otherwise
    than one that read them, and the two packages agree either way."""
    p, j, _ = ict_pair(tmp_path, seed=7, query_in_block_prob=0.5)
    p2, j2, _ = ict_pair(tmp_path, seed=7, query_in_block_prob=0.5)
    read = [p[i] for i in range(60)]
    skipped = [p2[i] for i in range(40, 60)]
    for got, want in ((read, [j[i] for i in range(60)]),
                      (skipped, [j2[i] for i in range(40, 60)])):
        for a, b in zip(got, want):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert any(not np.array_equal(a[k], b[k])
               for a, b in zip(read[40:], skipped)
               for k in ("query_tokens", "context_tokens"))


def test_ict_blocks_equal_the_jax_blocks(tmp_path):
    p, j, _ = ict_pair(tmp_path, seed=2, query_in_block_prob=0.1)
    for row in np.asarray(p.samples_mapping)[:25]:
        s, e, d, _ = (int(x) for x in row)
        for a, b in zip(p.get_block(s, e, d), j.get_block(s, e, d)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(p.get_null_block(), j.get_null_block()):
        np.testing.assert_array_equal(a, b)
    toks, mask = p.get_null_block()
    assert toks.shape == (48,) and int(mask.sum()) == 3


def test_t5_dict_batches_equal_the_jax_loader(tmp_path):
    vocab, prefix, _ = write_corpus(tmp_path, seed=5)
    ptok, jtok = tokenizers(vocab)
    args = ("100,0,0", [64, 0, 0], 48, 0.15, 0.1, 3)
    pds = build_train_valid_test_datasets(prefix, *args, ptok,
                                          dataset_type="t5",
                                          max_seq_length_dec=32)[0]
    jds = jax_build(prefix, *args, jtok, dataset_type="t5",
                    max_seq_length_dec=32)[0]
    for consumed in (0, 12):
        pl = iter(build_pretraining_data_loader(pds, consumed, 3, 2, 2,
                                                keys=T5_KEYS))
        jl = iter(jax_loader(jds, consumed, 3, 2, 2, keys=T5_KEYS))
        for _ in range(3):
            pb, jb = next(pl), next(jl)
            assert list(pb) == list(jb) == T5_KEYS
            for k in T5_KEYS:
                np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
            assert pb["text_enc"].shape == (2, 6, 48)
            assert pb["text_dec"].shape == (2, 6, 32)


def test_ict_dict_batches_equal_the_jax_loader(tmp_path):
    for consumed in (0, 12):
        # a fresh pair a resume point: each dataset's stream starts over,
        # as a resumed run's does
        d = tmp_path / str(consumed)
        d.mkdir()
        p, j, _ = ict_pair(d, seed=6, query_in_block_prob=0.2)
        pl = iter(build_pretraining_data_loader(p, consumed, 4, 1, 2,
                                                keys=ICT_KEYS))
        jl = iter(jax_loader(j, consumed, 4, 1, 2, keys=ICT_KEYS))
        for _ in range(4):
            pb, jb = next(pl), next(jl)
            assert list(pb) == list(jb) == ICT_KEYS
            for k in ICT_KEYS:
                np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
            assert pb["query_tokens"].shape == (2, 4, 48)


def test_t5_tokens_and_padded_vocab_equal_the_jax_tokenizer(tmp_path):
    """At bert-large-uncased's 30522 entries: 30522 + [BOS] + [EOS] + 100
    sentinels = 30624, padded to 30720 (a multiple of 128)."""
    words = [f"t{i}" for i in range(30522 - 5)]
    vpath = tmp_path / "vocab.txt"
    vpath.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                "[MASK]"] + words) + "\n")
    ptok, jtok = tokenizers(str(vpath))
    assert ptok.vocab_size == jtok.vocab_size == 30624
    assert ptok.padded_vocab_size == jtok.padded_vocab_size == 30720
    assert (ptok.bos_token_id, ptok.eos_token_id) == (
        jtok.bos_token_id, jtok.eos_token_id) == (30522, 30523)
    assert ptok.additional_special_tokens_ids == \
        jtok.additional_special_tokens_ids == list(range(30524, 30624))
