"""PyTorch port, the ORQA retrieval stack against the JAX package's, on
the CPU in fp32 at tiny widths (2 layers, hidden 64), on synthetic
evidence, NQ and DPR files made from a seed:

- the embedding store: a shard merge equal bit for bit to the JAX
  merge's file, each package loading the other's store, duplicate ids
  refused;
- `MIPSIndex`: top-k ids equal to the JAX index's and scores within
  1e-5, over chunkings that leave a partial tail (one with every score
  negative and the best row in the tail), and the reconstructed rows;
- the index builder on a converted JAX checkpoint: its store within
  1e-5 of the JAX tool's, the same ids;
- RETRIEVER-EVAL and ICT-ZEROSHOT-NQ through `tasks.main` on a
  converted checkpoint, on the fly and from a prebuilt store, for
  `--match string` and `regex`: the same retrieved ids, hit rates and
  match counts as the JAX entry's;
- the optimizer of RET-FINETUNE-NQ against `optax.adamw` on the same
  gradients, within 1e-6;
- RET-FINETUNE-NQ through `tasks.main` for shared and separate towers,
  with and without hard negatives: batches bit for bit, losses and
  in-batch top-1 within 1e-5 over 2 epochs, the final parameters within
  1e-5 but for at most 1e-3 of the elements (those whose gradient is
  roundoff, which Adam steps by about lr either way: each within 12 lr).
"""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu import arguments as jax_args
from megatron_llm_tpu import config as jax_config
from megatron_llm_tpu.data import realm_index as jax_realm
from megatron_llm_tpu.models.biencoder import BiEncoderModel as JaxBiEncoder
from megatron_llm_tpu.tokenizer import build_tokenizer as jax_tokenizer
from megatron_llm_tpu.training import checkpointing as jax_ckpt
from megatron_llm_tpu_torch import arguments
from megatron_llm_tpu_torch import config as port_config
from megatron_llm_tpu_torch.convert.from_jax import checkpoint_from_jax
from megatron_llm_tpu_torch.data import realm_index
from megatron_llm_tpu_torch.tasks import main as tasks_main
from megatron_llm_tpu_torch.tasks.orqa import supervised as port_sup
from megatron_llm_tpu_torch.tools import build_retrieval_index

from torch_parity import close

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

WORDS = [f"w{i}" for i in range(60)]
ARCH = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            seq_length=32)
ARGV = ("--num_layers 2 --hidden_size 64 --num_attention_heads 4 "
        "--seq_length 32 --max_position_embeddings 32 "
        "--retriever_seq_length 32 --micro_batch_size 4 "
        "--data_parallel_size 1 --hidden_dropout 0 --attention_dropout 0 "
        "--tokenizer_type BertWordPieceLowerCase --seed 3")


@pytest.fixture(autouse=True)
def _no_jax_context_left():
    """The JAX entry installs its parallel context for the process: drop
    it after each test, so that a later file in the same worker does not
    inherit it."""
    yield
    from megatron_llm_tpu.parallel.mesh import destroy_parallel

    destroy_parallel()


def _jax_tasks_main():
    from tasks import main as jax_tasks_main

    return jax_tasks_main


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_build_retrieval_index",
        os.path.join(REPO, "tools", "build_retrieval_index.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_vocab(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                               "[MASK]"] + WORDS) + "\n")
    return str(path)


def text(rs, lo, hi):
    return " ".join(rs.choice(WORDS, rs.randint(lo, hi)))


def write_evidence(tmp_path, n=23, seed=0):
    """A DPR evidence TSV of `n` distinct passages (ids 1..n): (path,
    [(id, text, title)])."""
    rs = np.random.RandomState(seed)
    docs, seen = [], set()
    while len(docs) < n:
        body = text(rs, 4, 12)
        if body not in seen:
            seen.add(body)
            docs.append((str(len(docs) + 1), body, text(rs, 1, 3)))
    path = tmp_path / "evidence.tsv"
    path.write_text("id\ttext\ttitle\n" + "".join(
        f"{i}\t{b}\t{t}\n" for i, b, t in docs))
    return str(path), docs


def write_nq(tmp_path, docs, regex, n=9, seed=1, name="nq_dev"):
    """NQ-open TSV: questions whose answers are words of some passages
    (regex: a pattern over them)."""
    rs = np.random.RandomState(seed)
    lines = []
    for _ in range(n):
        words = docs[rs.randint(len(docs))][1].split()
        answer = words[rs.randint(len(words))]
        if regex:
            answer = answer[:-1] + r"\d" if len(answer) > 2 else answer
        lines.append(f"{text(rs, 3, 8)}\t{json.dumps([answer])}\n")
    path = tmp_path / f"{name}.tsv"
    path.write_text("".join(lines))
    return str(path)


def jitter(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32), tree)


def checkpoints(tmp_path, vocab, shared=False, proj=0, seed=4):
    """A JAX biencoder save on jittered weights and its port copy through
    `checkpoint_from_jax`: (jax dir, port dir)."""
    tok = jax_tokenizer("BertWordPieceLowerCase", vocab_file=vocab)
    cfg = jax_config.bert_config(**ARCH, vocab_size=tok.vocab_size,
                                 add_binary_head=False,
                                 compute_dtype=jnp.float32)
    model = JaxBiEncoder(cfg, projection_dim=proj,
                         shared_query_context_model=shared)
    tree = jitter(model.init(jax.random.key(seed)), seed)
    jdir = str(tmp_path / f"jax_bienc_{shared}_{proj}")
    pdir = str(tmp_path / f"port_bienc_{shared}_{proj}")
    # made first: the JAX save writes meta.json there while orbax's
    # asynchronous save may not have made it yet
    os.makedirs(jax_ckpt.checkpoint_dir(jdir, 1))
    jax_ckpt.save_checkpoint(jdir, 1, jax.tree.map(jnp.asarray, tree),
                             None, cfg)
    checkpoint_from_jax(tree, None, {"iteration": 1, "config": {
        "kv_channels": cfg.kv_channels,
        "num_attention_heads": cfg.num_attention_heads,
        "num_attention_heads_kv": cfg.num_attention_heads_kv}}, pdir)
    return jdir, pdir


def fp32_configs(monkeypatch):
    """Both packages' entries and tools build fp32 models."""
    def cfg_fp32(inner, dtype):
        return lambda *a, **kw: dataclasses.replace(inner(*a, **kw),
                                                    compute_dtype=dtype)

    def args_fp32(inner, dtype):
        def wrapped(args, vocab, *a, **kw):
            m, p, tc, d = inner(args, vocab, *a, **kw)
            return dataclasses.replace(m, compute_dtype=dtype), p, tc, d
        return wrapped

    monkeypatch.setattr(jax_config, "bert_config",
                        cfg_fp32(jax_config.bert_config, jnp.float32))
    monkeypatch.setattr(port_config, "bert_config",
                        cfg_fp32(port_config.bert_config, torch.float32))
    monkeypatch.setattr(jax_args, "args_to_configs",
                        args_fp32(jax_args.args_to_configs, jnp.float32))
    monkeypatch.setattr(arguments, "args_to_configs",
                        args_fp32(arguments.args_to_configs, torch.float32))


# ---------------------------------------------------------------------------
# the store and the index
# ---------------------------------------------------------------------------


def _write_shards(store_cls, path, rs_seed, **kw):
    rs = np.random.RandomState(rs_seed)
    for rank, ids in enumerate(([5, 1, 9], [], [2, 7])):
        s = store_cls(path, load_from_path=False, rank=rank)
        if ids:
            s.add_block_data(ids, rs.randn(len(ids), 8).astype(np.float32))
        s.save_shard()
    return s


def test_store_merge_equals_the_jax_merge_and_loads_across(tmp_path):
    jpath, ppath = str(tmp_path / "jax_emb"), str(tmp_path / "port_emb")
    _write_shards(jax_realm.OpenRetrievalDataStore, jpath, 0) \
        .merge_shards_and_save()
    _write_shards(realm_index.OpenRetrievalDataStore, ppath, 0) \
        .merge_shards_and_save()
    with np.load(jpath + ".npz") as j, np.load(ppath + ".npz") as p:
        assert sorted(j.files) == sorted(p.files) == ["embeds", "ids"]
        for k in j.files:
            assert j[k].dtype == p[k].dtype and j[k].shape == p[k].shape
            assert j[k].tobytes() == p[k].tobytes(), k
    assert not [f for f in os.listdir(tmp_path) if ".shard" in f]

    port_reads_jax = realm_index.OpenRetrievalDataStore(jpath)
    jax_reads_port = jax_realm.OpenRetrievalDataStore(ppath)
    assert sorted(port_reads_jax.embed_data) == \
        sorted(jax_reads_port.embed_data) == [1, 2, 5, 7, 9]
    for rid, emb in port_reads_jax.embed_data.items():
        np.testing.assert_array_equal(emb, jax_reads_port.embed_data[rid])

    dup = str(tmp_path / "dup")
    for rank in (0, 1):
        s = realm_index.OpenRetrievalDataStore(dup, load_from_path=False,
                                               rank=rank)
        s.add_block_data([3], np.ones((1, 8), np.float32))
        s.save_shard()
    with pytest.raises(ValueError, match="duplicate"):
        s.merge_shards_and_save()
    with pytest.raises(ValueError, match="duplicate"):
        s.add_block_data([3], np.ones((1, 8), np.float32))


@pytest.mark.parametrize("n,chunk_rows,top_k", [
    (37, 8, 5), (37, 16, 20), (37, 1 << 20, 10), (40, 8, 40), (5, 4, 2)])
def test_mips_index_matches_the_jax_index(n, chunk_rows, top_k):
    rs = np.random.RandomState(n + chunk_rows)
    if n == 5:
        # every score negative, the best row alone in the padded tail: a
        # pad row's 0.0 would displace it without the -inf mask
        q = -np.abs(rs.rand(3, 8).astype(np.float32)) - 0.5
        ev = np.abs(rs.rand(n, 8).astype(np.float32)) + 0.5
        ev[4] *= 0.01
    else:
        q = rs.randn(6, 8).astype(np.float32)
        ev = rs.randn(n, 8).astype(np.float32)
    keys = np.sort(rs.permutation(1000)[:n] + 1)  # row i has keys[i]
    data = {int(i): e for i, e in zip(keys, ev)}
    jax_index = jax_realm.MIPSIndex(8, data, chunk_rows=chunk_rows)
    index = realm_index.MIPSIndex(8, data, chunk_rows=chunk_rows,
                                  device="cpu")
    assert len(index) == len(jax_index) == n
    js, ji = jax_index.search_mips_index(q, top_k)
    ps, pi = index.search_mips_index(q, top_k)
    assert pi.dtype == ji.dtype and pi.shape == ji.shape
    np.testing.assert_array_equal(pi, ji)
    close(ps, js, 1e-5)
    if n == 5:
        assert (js < 0).all() and (pi[:, 0] == keys[4]).all()
    _, jrec = jax_index.search_mips_index(q, top_k, reconstruct=True)
    _, prec = index.search_mips_index(q, top_k, reconstruct=True)
    np.testing.assert_array_equal(prec, jrec)


# ---------------------------------------------------------------------------
# the index builder and the retriever evaluation
# ---------------------------------------------------------------------------


def _tool_argv(vocab, evidence, out, load):
    return ["--evidence_data_path", evidence, "--embedding_path", out,
            "--load", load, "--tokenizer_type", "BertWordPieceLowerCase",
            "--vocab_file", vocab, "--num_layers", "2", "--hidden_size",
            "64", "--num_attention_heads", "4", "--retriever_seq_length",
            "32", "--indexer_batch_size", "4"]


def test_index_builder_matches_the_jax_tool(tmp_path, monkeypatch):
    fp32_configs(monkeypatch)
    vocab = write_vocab(tmp_path)
    evidence, docs = write_evidence(tmp_path)
    jdir, pdir = checkpoints(tmp_path, vocab)
    jout, pout = str(tmp_path / "jax_idx.npz"), str(tmp_path / "port_idx")
    _jax_tool().main(_tool_argv(vocab, evidence, jout, jdir))
    path = build_retrieval_index.main(
        _tool_argv(vocab, evidence, pout, pdir), device="cpu")
    assert path == pout + ".npz"
    with np.load(jout) as j, np.load(path) as p:
        np.testing.assert_array_equal(p["ids"], j["ids"])
        assert p["ids"].tolist() == list(range(1, len(docs) + 1))
        assert p["embeds"].shape == j["embeds"].shape == (len(docs), 64)
        close(p["embeds"], j["embeds"], 1e-5)


def _record(monkeypatch, cls, name, log):
    inner = getattr(cls, name)

    def wrapped(self, *a, **kw):
        out = inner(self, *a, **kw)
        log.append(out)
        return out

    monkeypatch.setattr(cls, name, wrapped)


@pytest.mark.parametrize("task,match,shared", [
    ("RETRIEVER-EVAL", "string", False),
    ("ICT-ZEROSHOT-NQ", "regex", True)])
def test_retriever_eval_matches_the_jax_entry(tmp_path, monkeypatch, task,
                                              match, shared):
    from tasks.orqa.evaluate import ORQAEvaluator as JaxEvaluator

    fp32_configs(monkeypatch)
    vocab = write_vocab(tmp_path)
    evidence, docs = write_evidence(tmp_path)
    dev = write_nq(tmp_path, docs, regex=match == "regex")
    test = write_nq(tmp_path, docs, regex=match == "regex", seed=2,
                    name="nq_test")
    jdir, pdir = checkpoints(tmp_path, vocab, shared=shared,
                             proj=16 if shared else 0)
    flags = ["--biencoder_shared_query_context_model",
             "--biencoder_projection_dim", "16"] if shared else []
    tool = _tool_argv(vocab, evidence, "", "")[6:] + flags
    jstore, pstore = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    _jax_tool().main(["--evidence_data_path", evidence, "--embedding_path",
                      jstore, "--load", jdir] + tool)
    build_retrieval_index.main(["--evidence_data_path", evidence,
                                "--embedding_path", pstore, "--load",
                                pdir] + tool, device="cpu")

    argv = ARGV.split() + flags + [
        "--task", task, "--vocab_file", vocab, "--evidence_data_path",
        evidence, "--qa_data_dev", dev, "--qa_data_test", test,
        "--retriever_topk", "5", "--match", match]
    jax_evals, jax_ids = [], []
    _record(monkeypatch, JaxEvaluator, "evaluate", jax_evals)
    _record(monkeypatch, JaxEvaluator, "retrieve", jax_ids)
    runs = {}
    for name, extra in (("fly", []), ("prebuilt", ["--embedding_path"])):
        _jax_tasks_main().main(argv + ["--load", jdir] + (
            extra and extra + [jstore]))
        runs[name] = tasks_main.main(argv + ["--load", pdir] + (
            extra and extra + [pstore]), device="cpu")
    assert len(jax_evals) == len(jax_ids) == 4
    for r, (name, (evaluator, results)) in enumerate(runs.items()):
        assert list(results) == ["DEV", "TEST"]
        for s, split in enumerate(("DEV", "TEST")):
            rates, stats = results[split]
            jrates, jstats = jax_evals[2 * r + s]
            assert rates == jrates and len(rates) == 5
            assert stats.top_k_hits == jstats.top_k_hits
            assert stats.questions_doc_hits == jstats.questions_doc_hits
        # the DEV questions' retrieved ids, by both packages, on the fly
        # and from the stores, and their scores
        questions = [ln.split("\t")[0] for ln in open(dev)]
        got = evaluator.retrieve(questions, 5)
        for (ids, scores), (jids, jscores) in zip(got, jax_ids[2 * r]):
            assert ids == jids
            # 1e-5 of the largest score where that passes 1: a score sums
            # 64 products of embeddings each within 1e-5
            close(scores, jscores,
                  1e-5 * max(1.0, float(np.abs(jscores).max())))
    assert runs["fly"][1]["DEV"][1].questions_doc_hits == \
        runs["prebuilt"][1]["DEV"][1].questions_doc_hits
    # some answers found, some not: the counts are not vacuous
    hits = runs["fly"][1]["DEV"][1].top_k_hits
    assert 0 < hits[-1] and hits[0] < 9


# ---------------------------------------------------------------------------
# RET-FINETUNE-NQ
# ---------------------------------------------------------------------------


def write_dpr(tmp_path, n=12, seed=5):
    """DPR retriever-train json: a question, its answers, a positive
    context with a title, and 0-2 hard negatives a sample."""
    rs = np.random.RandomState(seed)
    samples = []
    for i in range(n):
        negs = [{"title": text(rs, 1, 3), "text": text(rs, 4, 10)}
                for _ in range(rs.randint(0, 3))]
        samples.append({
            "question": text(rs, 3, 7), "answers": [WORDS[i]],
            "positive_ctxs": [{"title": text(rs, 1, 3),
                               "text": text(rs, 4, 10)}],
            "hard_negative_ctxs": negs})
    path = tmp_path / "nq_train.json"
    path.write_text(json.dumps(samples))
    return str(path)


def test_adamw_step_is_optax_adamw():
    """`adamw_step` against `optax.adamw(lr)` at its defaults, on the same
    gradients for 5 steps: a leaf without a gradient (None in the port)
    takes JAX's zeros, and moves by the weight decay alone."""
    import optax

    rs = np.random.RandomState(9)
    tree = {"a": rs.randn(4, 3).astype(np.float32),
            "b": {"c": rs.randn(5).astype(np.float32),
                  "tokentype": rs.randn(2, 3).astype(np.float32)}}
    opt = optax.adamw(1e-3)
    jp, state = jax.tree.map(jnp.asarray, tree), None
    state = opt.init(jp)
    pp = port_sup.tree_map(lambda a: torch.tensor(a), tree)
    pstate = {"count": 0, "mu": port_sup.tree_map(torch.zeros_like, pp),
              "nu": port_sup.tree_map(torch.zeros_like, pp)}
    for step in range(5):
        grads = jax.tree.map(
            lambda a: (rs.randn(*a.shape) * 10.0 ** -step).astype(
                np.float32), tree)
        grads["b"]["tokentype"] = np.zeros((2, 3), np.float32)
        updates, state = opt.update(jax.tree.map(jnp.asarray, grads), state,
                                    jp)
        jp = optax.apply_updates(jp, updates)
        for leaf, g in zip(port_sup.tree_leaves(pp),
                           port_sup.tree_leaves(grads)):
            leaf.grad = None if not g.any() else torch.tensor(g)
        port_sup.adamw_step(pp, pstate, 1e-3)
    for leaf, want in zip(port_sup.tree_leaves(pp),
                          port_sup.tree_leaves(
                              jax.tree.map(np.asarray, jp))):
        close(leaf, want, 1e-6)
    moved = np.abs(pp["b"]["tokentype"].numpy() - tree["b"]["tokentype"])
    assert 0 < moved.max() < 1e-6  # 5 steps of lr x 1e-4 x |p| < 2


# Adam steps each element by about lr whatever its gradient's size, so an
# element whose gradient is zero in exact arithmetic (an attention key
# bias; a bias that shifts every context embedding alike, to which the
# in-batch softmax is blind) steps by each package's own roundoff: at
# lr 1e-5 those steps move the losses by less than 1e-5
FT_LR = 1e-5


@pytest.mark.parametrize("shared,hard", [
    (False, False), (False, True), (True, False), (True, True)])
def test_ret_finetune_matches_the_jax_entry(tmp_path, monkeypatch, shared,
                                            hard):
    from tasks.orqa import supervised as jax_sup

    fp32_configs(monkeypatch)
    vocab = write_vocab(tmp_path)
    train = write_dpr(tmp_path)
    jdir, pdir = checkpoints(tmp_path, vocab, shared=shared)

    jax_losses, jax_batches, jax_params = [], [], []
    inner_loss_fn = jax_sup.make_loss_fn

    def recorded_loss_fn(model, use_hard_negatives):
        inner = inner_loss_fn(model, use_hard_negatives)

        def loss_fn(params, batch, rng=None):
            loss, top1 = inner(params, batch, rng)
            jax.debug.callback(
                lambda a, b: jax_losses.append((float(a), float(b))),
                loss, top1)
            return loss, top1
        return loss_fn

    inner_batch, inner_ft = jax_sup._batch, jax_sup.finetune_retriever

    def recorded_batch(ds, idxs):
        out = inner_batch(ds, idxs)
        jax_batches.append({k: np.asarray(v) for k, v in out.items()})
        return out

    def recorded_ft(*a, **kw):
        out = inner_ft(*a, **kw)
        jax_params.append(jax.tree.map(np.asarray, out))
        return out

    monkeypatch.setattr(jax_sup, "make_loss_fn", recorded_loss_fn)
    monkeypatch.setattr(jax_sup, "_batch", recorded_batch)
    monkeypatch.setattr(jax_sup, "finetune_retriever", recorded_ft)
    port_batches = []
    inner_host = port_sup.host_batch
    monkeypatch.setattr(port_sup, "host_batch", lambda ds, idxs: (
        port_batches.append(inner_host(ds, idxs)) or port_batches[-1]))

    argv = ARGV.split() + ["--task", "RET-FINETUNE-NQ", "--vocab_file",
                           vocab, "--train_data", train, "--epochs", "2",
                           "--lr", str(FT_LR), "--log_interval", "1"] + (
        ["--biencoder_shared_query_context_model"] if shared else []) + (
        ["--use_hard_negatives"] if hard else [])
    _jax_tasks_main().main(argv + ["--pretrained_checkpoint", jdir])
    jax.effects_barrier()
    port_losses = []
    params = tasks_main.main(argv + ["--pretrained_checkpoint", pdir],
                             device="cpu", losses=port_losses)

    assert len(port_batches) == len(jax_batches) == 6  # 2 epochs x 3
    for pb, jb in zip(port_batches, jax_batches):
        assert set(pb) == set(jb) == (
            {"query", "query_mask", "context", "context_mask"}
            | ({"neg_context", "neg_context_mask", "neg_valid"}
               if hard else set()))
        for k in jb:
            assert pb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    if hard:
        assert {int(v) for b in jax_batches for v in b["neg_valid"]} \
            == {0, 1}
    assert len(port_losses) == len(jax_losses) == 6
    for i, ((pl, pt), (jl, jt)) in enumerate(zip(port_losses, jax_losses)):
        assert abs(pl - jl) <= 1e-5 and abs(pt - jt) <= 1e-5, (i, pl, jl)
    assert len({round(x[0], 6) for x in port_losses}) == 6

    flat_j = jax.tree_util.tree_flatten_with_path(jax_params[0])[0]
    assert set(params) == ({"shared"} if shared else {"query", "context"})
    total = beyond = 0
    for path, a in flat_j:
        leaf = params
        for k in path:
            leaf = leaf[k.key]
        diff = np.abs(leaf.numpy() - a)
        total += diff.size
        beyond += int((diff > 1e-5).sum())
        # a roundoff gradient steps about lr a step in either package
        assert diff.max() <= 2 * 6 * FT_LR, jax.tree_util.keystr(path)
    assert beyond <= 1e-3 * total, (beyond, total)
