"""PyTorch port, the GPT data pipeline against the JAX package's.

Exact equality throughout, on corpora written in-test from a seed: the
.bin/.idx bytes of both builders (merges too), the sample and blend
indices of the port's g++ helpers against the JAX package's and the
plain numpy versions, the GPTDataset's doc/sample/shuffle indices and
every sample's tokens (one epoch, and several with the last epoch
shuffled on its own), the cache file names and the port reading a cache
the JAX package wrote, blends and separate train/valid/test corpora,
both samplers resumed part-way, and the loader's batches under a
batch-size rampup.
"""

import os

import numpy as np
import pytest

from megatron_llm_tpu.data import data_samplers as jax_samplers
from megatron_llm_tpu.data import gpt_dataset as jax_gpt
from megatron_llm_tpu.data import helpers as jax_helpers
from megatron_llm_tpu.data import indexed_dataset as jax_idx
from megatron_llm_tpu.training import microbatches as jax_micro
from megatron_llm_tpu_torch.data import data_samplers, gpt_dataset, helpers
from megatron_llm_tpu_torch.data import indexed_dataset as idx
from megatron_llm_tpu_torch.training import microbatches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _docs(seed, n, lo=3, hi=60, vocab=1000):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, size=rs.randint(lo, hi)) for _ in range(n)]


def _write(module, prefix, docs, dtype):
    b = module.MMapIndexedDatasetBuilder(prefix + ".bin", dtype=dtype)
    for d in docs:
        b.add_item(d)
        b.end_document()
    b.finalize(prefix + ".idx")
    return prefix


def _bytes(prefix):
    return tuple(open(prefix + ext, "rb").read() for ext in (".bin", ".idx"))


@pytest.fixture
def corpora(tmp_path):
    """Two corpora written by the JAX builder: A (300 docs) and B (200)."""
    return (_write(jax_idx, str(tmp_path / "A"), _docs(0, 300), np.uint16),
            _write(jax_idx, str(tmp_path / "B"), _docs(1, 200), np.uint16))


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_builder_bytes_equal(tmp_path, dtype):
    docs = _docs(2, 30, vocab=60000)
    a = _write(jax_idx, str(tmp_path / "jax"), docs, dtype)
    b = _write(idx, str(tmp_path / "port"), docs, dtype)
    assert _bytes(a) == _bytes(b)
    ds = idx.MMapIndexedDataset(b)
    assert len(ds) == 30 and ds.dtype == np.dtype(dtype)
    for i, d in enumerate(docs):
        np.testing.assert_array_equal(ds[i], d)
    np.testing.assert_array_equal(ds.get(3, offset=1, length=2), docs[3][1:3])
    ds.close()


def test_merge_bytes_equal(tmp_path):
    parts = [_write(jax_idx, str(tmp_path / f"p{i}"), _docs(10 + i, 7),
                    np.uint16) for i in range(3)]
    outs = []
    for name, module in (("jax", jax_idx), ("port", idx)):
        prefix = str(tmp_path / f"merged_{name}")
        b = module.MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
        for p in parts:
            b.merge_file_(p)
        b.finalize(prefix + ".idx")
        outs.append(_bytes(prefix))
    assert outs[0] == outs[1]
    assert len(idx.MMapIndexedDataset(str(tmp_path / "merged_port"))) == 21


def test_best_fitting_dtype_and_bad_magic(tmp_path):
    for v in (None, 100, 65499, 65500, 200000):
        assert idx.best_fitting_dtype(v) == jax_idx.best_fitting_dtype(v)
    bad = tmp_path / "bad.idx"
    bad.write_bytes(b"NOTANIDX" + b"\0" * 40)
    with pytest.raises(ValueError, match="bad magic"):
        idx._Index(str(bad))


@pytest.mark.parametrize("seq_length,num_epochs", [(16, 1), (7, 3),
                                                   (64, 2)])
def test_build_sample_idx_port_jax_numpy(seq_length, num_epochs):
    rs = np.random.RandomState(seq_length)
    sizes = rs.randint(1, 50, 200).astype(np.int32)
    doc_idx = np.concatenate([rs.permutation(200) for _ in
                              range(num_epochs)]).astype(np.int32)
    tpe = int(sizes.sum())
    port = helpers.build_sample_idx(sizes, doc_idx, seq_length, num_epochs,
                                    tpe)
    np.testing.assert_array_equal(
        port, helpers.build_sample_idx_np(sizes, doc_idx, seq_length,
                                          num_epochs, tpe))
    np.testing.assert_array_equal(
        port, jax_helpers.build_sample_idx(sizes, doc_idx, seq_length,
                                           num_epochs, tpe))
    assert helpers.library_path().parent.name == "build"


@pytest.mark.parametrize("weights", [[0.7, 0.3], [0.2, 0.5, 0.3],
                                     [1.0, 1.0, 1.0, 5.0]])
def test_build_blending_indices_port_jax_numpy(weights):
    w = np.asarray(weights, np.float64) / np.sum(weights)
    port = helpers.build_blending_indices(w, 997)
    for other in (helpers.build_blending_indices_np(w, 997),
                  jax_helpers.build_blending_indices(w, 997)):
        for a, b in zip(port, other):
            np.testing.assert_array_equal(a, b)


def test_helpers_build_failure_raises(monkeypatch, tmp_path):
    """A failing g++ build raises; nothing falls back to numpy."""
    bad = tmp_path / "helpers.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(helpers, "SOURCE", bad)
    monkeypatch.setattr(helpers, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(helpers, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        helpers.build_sample_idx(np.ones(4, np.int32),
                                 np.arange(4, dtype=np.int32), 2, 1, 4)


def _same_dataset(jax_ds, port_ds):
    assert len(jax_ds) == len(port_ds)
    for name in ("doc_idx", "sample_idx", "shuffle_idx"):
        a, b = getattr(jax_ds, name), getattr(port_ds, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for i in range(len(jax_ds)):
        a, b = jax_ds[i]["text"], port_ds[i]["text"]
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b, err_msg=f"sample {i}")


@pytest.mark.parametrize("num_samples,seq_length", [
    (50, 32),     # one epoch
    (700, 16),    # several epochs, the last under 80%: shuffled apart
    (600, 29),    # several epochs, the last one whole
])
def test_gpt_dataset_equal(corpora, num_samples, seq_length):
    prefix = corpora[0]
    docs = np.arange(100, dtype=np.int32)
    j = jax_gpt.GPTDataset("train", prefix, docs,
                           jax_idx.MMapIndexedDataset(prefix), num_samples,
                           seq_length, 1234, build_cache=False)
    p = gpt_dataset.GPTDataset("train", prefix, docs,
                               idx.MMapIndexedDataset(prefix), num_samples,
                               seq_length, 1234, build_cache=False)
    _same_dataset(j, p)
    assert len(p) >= num_samples
    assert all(len(p[i]["text"]) == seq_length + 1 for i in range(len(p)))


def test_separate_last_epoch_is_exercised(corpora):
    """The 700-sample case above shuffles its last epoch on its own."""
    ds = idx.MMapIndexedDataset(corpora[0])
    tpe = int(np.sum(ds.sizes[:100]))
    n_epochs = gpt_dataset._num_epochs(tpe, 16, 700)
    per_epoch = (tpe - 1) // 16
    last = 700 - ((n_epochs - 1) * tpe - 1) // 16
    assert n_epochs > 1 and last < int(0.8 * per_epoch)


def test_cache_names_equal_and_port_reads_jax_cache(corpora, monkeypatch):
    prefix = corpora[0]
    docs = np.arange(100, dtype=np.int32)
    j = jax_gpt.GPTDataset("valid", prefix, docs,
                           jax_idx.MMapIndexedDataset(prefix), 300, 24, 7)
    names = gpt_dataset.index_mapping_filenames(prefix, "valid", 300, 24, 7)
    assert all(os.path.isfile(f) for f in names)
    assert os.path.basename(names[0]) == "A_valid_indexmap_300ns_24sl_7s" \
        "_doc_idx.npy"
    before = [os.stat(f).st_mtime_ns for f in names]

    def no_build(*a, **k):
        raise AssertionError("the port rebuilt a cached index")

    monkeypatch.setattr(gpt_dataset.helpers, "build_sample_idx", no_build)
    p = gpt_dataset.GPTDataset("valid", prefix, docs,
                               idx.MMapIndexedDataset(prefix), 300, 24, 7)
    _same_dataset(j, p)
    assert [os.stat(f).st_mtime_ns for f in names] == before


def test_port_writes_the_cache_jax_reads(corpora):
    prefix = corpora[1]
    docs = np.arange(60, dtype=np.int32)
    p = gpt_dataset.GPTDataset("train", prefix, docs,
                               idx.MMapIndexedDataset(prefix), 120, 20, 3)
    names = gpt_dataset.index_mapping_filenames(prefix, "train", 120, 20, 3)
    assert all(os.path.isfile(f) for f in names)
    assert not [f for f in os.listdir(os.path.dirname(prefix))
                if ".tmp" in f]
    j = jax_gpt.GPTDataset("train", prefix, docs,
                           jax_idx.MMapIndexedDataset(prefix), 120, 20, 3)
    _same_dataset(j, p)


def _same_splits(a, b):
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is None:
            continue
        assert len(x) == len(y)
        for i in range(len(x)):
            np.testing.assert_array_equal(x[i]["text"], y[i]["text"])


@pytest.mark.parametrize("split", ["98,2,0", "80,10,10", "1"])
def test_blend_equal(corpora, split):
    a, b = corpora
    kw = dict(data_prefix=["0.7", a, "0.3", b], splits_string=split,
              train_valid_test_num_samples=[400, 8, 4], seq_length=16,
              seed=5, build_cache=False)
    j = jax_gpt.build_train_valid_test_datasets(**kw)
    p = gpt_dataset.build_train_valid_test_datasets(**kw)
    _same_splits(j, p)
    if p[0] is not None:
        np.testing.assert_array_equal(p[0].dataset_index,
                                      j[0].dataset_index)


def test_separate_split_paths_equal(corpora):
    a, b = corpora
    kw = dict(data_prefix=None, train_data_prefix=["0.5", a, "0.5", b],
              valid_data_prefix=[b], test_data_prefix=a,
              train_valid_test_num_samples=[300, 30, 10], seq_length=16,
              seed=9, build_cache=False)
    j = jax_gpt.build_train_valid_test_datasets(**kw)
    p = gpt_dataset.build_train_valid_test_datasets(**kw)
    assert all(x is not None for x in p)
    _same_splits(j, p)


def test_split_boundaries_equal():
    for s in ("969,30,1", "98,2,0", "1/1/1", "7"):
        for n in (1, 17, 200, 1001):
            assert gpt_dataset.get_train_valid_test_split_(s, n) == \
                jax_gpt.get_train_valid_test_split_(s, n)


@pytest.mark.parametrize("kind", ["single", "cyclic"])
@pytest.mark.parametrize("consumed", [0, 12, 60])
def test_samplers_resume_equal(kind, consumed):
    cls = {"single": "MegatronPretrainingSampler",
           "cyclic": "MegatronPretrainingRandomSampler"}[kind]
    args = dict(total_samples=50, consumed_samples=consumed,
                micro_batch_size=2, data_parallel_size=2)
    if kind == "single" and consumed >= 50:
        return
    if kind == "single":
        args["drop_last"] = False
    j = list(getattr(jax_samplers, cls)(**args))
    p = list(getattr(data_samplers, cls)(**args))
    assert j == p and len(p) > 0
    if kind == "single":
        full = list(data_samplers.MegatronPretrainingSampler(
            50, 0, 2, 2, drop_last=False))
        assert p == full[consumed // 4:]


def test_loader_batches_under_rampup(corpora):
    """The loader asks the calculator at every step: a rampup of 2 -> 8
    in increments of 2 over 24 samples, mbs 2."""
    prefix = corpora[0]
    docs = np.arange(100, dtype=np.int32)
    dsj = jax_gpt.GPTDataset("train", prefix, docs,
                             jax_idx.MMapIndexedDataset(prefix), 200, 16, 1,
                             build_cache=False)
    dsp = gpt_dataset.GPTDataset("train", prefix, docs,
                                 idx.MMapIndexedDataset(prefix), 200, 16, 1,
                                 build_cache=False)
    runs = []
    for ds, micro, samplers in ((dsj, jax_micro, jax_samplers),
                                (dsp, microbatches, data_samplers)):
        calc = micro.build_num_microbatches_calculator(8, 2, 1, (2, 2, 24))
        loader = samplers.build_pretraining_data_loader(ds, 0, 2, 1,
                                                        calc.get)
        batches, consumed = [], 0
        for batch in loader:
            batches.append(batch)
            consumed += batch.shape[0] * batch.shape[1]
            calc.update(consumed)
            if len(batches) == 12:
                break
        runs.append(batches)
    j, p = runs
    assert [b.shape for b in p] == [b.shape for b in j]
    sizes = [b.shape[0] for b in p]
    assert sizes == sorted(sizes) and sizes[0] == 1 and sizes[-1] == 4
    for a, b in zip(j, p):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    # a batch's rows are the samples the sampler names, in order
    flat = np.concatenate([b.reshape(-1, 17) for b in p])
    for i in range(len(flat)):
        np.testing.assert_array_equal(flat[i], dsp[i]["text"])
