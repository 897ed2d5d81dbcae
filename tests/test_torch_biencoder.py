"""PyTorch port, the ICT biencoder against the JAX package's, on the CPU
in fp32 at tiny widths (2 layers, hidden 64):

- `BiEncoderModel.embed_text` (the CLS row, projected when
  projection_dim > 0) within 1e-5, the in-batch retrieval loss within
  1e-5 and every gradient leaf within 1e-5 of its largest element (an
  absolute 1e-5 below 1), for shared and separate towers, projection 0
  and 16, and under full recompute;
- the towers are headless: the tree's leaf names and shapes are the JAX
  package's, and `checkpoint_from_jax` carries every biencoder leaf
  (`query` / `context` / `shared`, `projection_enc`);
- entry parity: the JAX `pretrain_ict.main` trains 0 -> 3 and saves;
  that save, restored by the JAX loader and written by
  `checkpoint_from_jax`, resumes the port's `pretrain_ict.main` 3 -> 6
  beside the JAX entry resuming its own: the same batches (the datasets'
  draws in the same order), losses within 1e-5 (fp32, dropout 0);
- `pretrain_ict.main` refuses tp, SP, dp, pp and cp by name.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.config import bert_config as jax_bert_config
from megatron_llm_tpu.models.biencoder import BiEncoderModel as JaxBiEncoder
from megatron_llm_tpu.optimizer import init_optimizer_state as jax_init_opt
from megatron_llm_tpu.tokenizer import build_tokenizer as jax_tok
from megatron_llm_tpu.training import checkpointing as jax_ckpt
from megatron_llm_tpu.training.trainer import Trainer as JaxTrainer
from megatron_llm_tpu_torch import pretrain_bert, pretrain_ict
from megatron_llm_tpu_torch.config import bert_config
from megatron_llm_tpu_torch.convert.from_jax import (
    checkpoint_from_jax,
    params_from_jax,
)
from megatron_llm_tpu_torch.models.biencoder import BiEncoderModel
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
from megatron_llm_tpu_torch.training.checkpointing import (
    load_checkpoint,
    read_tracker,
)
from megatron_llm_tpu_torch.training.trainer import Trainer

from torch_parity import (
    close,
    jax_load_listing,
    jax_native_helpers,
    jax_saves_once_committed,
    t,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            seq_length=32, vocab_size=120, hidden_dropout=0.0,
            attention_dropout=0.0, add_binary_head=False)
B, S = 4, 32
TOWERS = [(False, 0), (False, 16), (True, 0), (True, 16)]


@pytest.fixture(autouse=True)
def _jax_helpers_loaded():
    """The JAX native helpers loaded in this worker, where a concurrent
    rebuild of a stale library left a failed load behind
    (torch_parity.jax_native_helpers)."""
    jax_native_helpers()


def pair(seed=0, shared=False, proj=0, **kw):
    kw = {**TINY, **kw}
    jc = jax_bert_config(compute_dtype=jnp.float32, **kw)
    pc = bert_config(compute_dtype=torch.float32, **kw)
    jm = JaxBiEncoder(jc, projection_dim=proj,
                      shared_query_context_model=shared)
    pm = BiEncoderModel(pc, projection_dim=proj,
                        shared_query_context_model=shared, device="cpu")
    rs = np.random.RandomState(seed)
    jp = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32), jm.init(jax.random.key(seed)))
    return jm, jp, pm, params_from_jax(jp, pc, device="cpu")


def batch(seed, vocab=120):
    rs = np.random.RandomState(seed)

    def keep(lengths):
        return (np.arange(S)[None] < np.array(lengths)[:, None]).astype(
            np.int32)
    return dict(
        query_tokens=rs.randint(0, vocab, (B, S)).astype(np.int32),
        query_mask=keep((9, 32, 5, 14)),
        context_tokens=rs.randint(0, vocab, (B, S)).astype(np.int32),
        context_mask=keep((32, 20, 27, 11)))


def leaf_at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("shared,proj", TOWERS)
def test_embed_text_matches_the_jax_towers(shared, proj):
    jm, jp, pm, pp = pair(seed=1, shared=shared, proj=proj)
    b = batch(2)
    assert set(pp) == ({"shared"} if shared else {"query", "context"})
    for side in pp:
        tower_j, tower_p = jp[side], pp[side]
        assert not {"lm_head", "pooler", "binary_head"} & set(tower_p)
        assert ("projection_enc" in tower_p) == (proj > 0)
        for tok, mask in (("query_tokens", "query_mask"),
                          ("context_tokens", "context_mask")):
            want = jm.embed_text(tower_j, jnp.asarray(b[tok]),
                                 jnp.asarray(b[mask]))
            with torch.no_grad():
                got = pm.embed_text(tower_p, t(b[tok]), t(b[mask]))
            assert got.shape == (B, proj or 64)
            close(got, want, 1e-5)


@pytest.mark.parametrize("shared,proj", TOWERS)
@pytest.mark.parametrize("policy", ["none", "full"])
def test_loss_and_gradients_match_the_jax_model(shared, proj, policy):
    jm, jp, pm, pp = pair(seed=3, shared=shared, proj=proj)
    pm.cfg = pm.bert.cfg = dataclasses.replace(pm.cfg, remat_policy=policy)
    b = batch(4)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(
        p, **{k: jnp.asarray(v) for k, v in b.items()}))(jp)
    for leaf in tree_leaves(pp):
        leaf.requires_grad_(True)
    ploss = pm.loss(pp, **{k: t(v) for k, v in b.items()})
    ploss.backward()
    assert abs(float(ploss.detach()) - float(jloss)) <= 1e-5
    flat_j = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat_j) == len(tree_leaves(pp))
    for path, g in flat_j:
        leaf = leaf_at(pp, path)
        # the towers read no tokentypes: autograd leaves that leaf's
        # gradient unset where JAX gives zeros (the train step reads an
        # unset gradient as zeros)
        got = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        # 1e-5 of the leaf's largest gradient where that passes 1: the
        # scores q . c run to tens, so a shared tower's gradients reach
        # several units, where fp32's summation order shows at 1e-5
        tol = 1e-5 * max(1.0, float(np.abs(np.asarray(g)).max()))
        close(got, g, tol, msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("shared,proj", TOWERS)
def test_tree_and_checkpoint_from_jax_carry_every_leaf(tmp_path, shared,
                                                        proj):
    jm, jp, pm, _ = pair(seed=5, shared=shared, proj=proj)
    meta_tree = pm.abstract_params()
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(tree_leaves(meta_tree))
    for path, a in flat_j:
        assert tuple(leaf_at(meta_tree, path).shape) == a.shape, path
    cfg = jm.cfg
    meta = {"iteration": 4, "consumed_train_samples": 32,
            "config": {"kv_channels": cfg.kv_channels,
                       "num_attention_heads": cfg.num_attention_heads,
                       "num_attention_heads_kv":
                           cfg.num_attention_heads_kv}}
    checkpoint_from_jax(jp, None, meta, str(tmp_path))
    assert read_tracker(str(tmp_path)) == (4, False)
    params, _, _, it = load_checkpoint(str(tmp_path), meta_tree, None,
                                       pm.cfg, device="cpu",
                                       no_load_optim=True)
    assert it == 4
    for path, a in flat_j:
        np.testing.assert_array_equal(leaf_at(params, path).numpy(),
                                      np.asarray(a))
    # the port's own init draws the same tree
    own = pm.init(seed=2)
    assert [tuple(x.shape) for x in tree_leaves(own)] == \
        [tuple(x.shape) for x in tree_leaves(meta_tree)]


# ---------------------------------------------------------------------------
# entry parity: pretrain_ict
# ---------------------------------------------------------------------------


def _jax_pretrain_ict():
    spec = importlib.util.spec_from_file_location(
        "jax_pretrain_ict_entry", os.path.join(REPO, "pretrain_ict.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _no_jax_context_left():
    yield
    from megatron_llm_tpu.parallel.mesh import destroy_parallel

    destroy_parallel()


def ict_corpus(tmp_path, n_docs=60, seed=0):
    """A WordPiece vocabulary, a sentence-split corpus and its titles
    (one item a document), built by the JAX package's builder: (vocab
    file, corpus prefix, titles prefix)."""
    from megatron_llm_tpu.data import indexed_dataset as jax_idx

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"w{i}" for i in range(80)] + [f"##p{i}" for i in range(30)]
    vpath = tmp_path / "vocab.txt"
    vpath.write_text("\n".join(vocab) + "\n")
    rs = np.random.RandomState(seed)
    prefix = str(tmp_path / "ict_text_sentence")
    titles = str(tmp_path / "ict_titles_document")
    b = jax_idx.MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    tb = jax_idx.MMapIndexedDatasetBuilder(titles + ".bin", dtype=np.uint16)
    for _ in range(n_docs):
        for _ in range(rs.randint(2, 6)):
            b.add_item(rs.randint(5, len(vocab), rs.randint(3, 12)))
        b.end_document()
        tb.add_item(rs.randint(5, len(vocab), rs.randint(1, 5)))
        tb.end_document()
    b.finalize(prefix + ".idx")
    tb.finalize(titles + ".idx")
    return str(vpath), prefix, titles


ICT_ARGV = ("--num_layers 2 --hidden_size 64 --num_attention_heads 4 "
            "--seq_length 32 --max_position_embeddings 32 "
            "--micro_batch_size 2 --global_batch_size 4 --lr 1e-3 "
            "--lr_decay_style linear --lr_warmup_iters 1 "
            "--tokenizer_type BertWordPieceLowerCase --log_interval 1 "
            "--hidden_dropout 0 --attention_dropout 0 "
            "--data_parallel_size 1 --seed 5 --query_in_block_prob 0.3 "
            "--make_vocab_size_divisible_by 8")


def _fp32(mod, dtype):
    inner = mod.args_to_configs

    def wrapped(args, vocab, *a, **kw):
        m, p, tc, d = inner(args, vocab, *a, **kw)
        return dataclasses.replace(m, compute_dtype=dtype), p, tc, d
    return wrapped


def _record(monkeypatch, cls, log):
    inner = cls.train_step

    def train_step(self, state, text, *a, **kw):
        stats = inner(self, state, text, *a, **kw)
        log.append((state.iteration, float(stats["loss"]),
                    {k: np.array(v) for k, v in text.items()},
                    state.consumed_train_samples))
        return stats

    monkeypatch.setattr(cls, "train_step", train_step)


@pytest.mark.parametrize("tower_flags", [
    "", "--biencoder_shared_query_context_model "
        "--biencoder_projection_dim 16"])
def test_entry_parity_jax_to_port(tmp_path, monkeypatch, tower_flags):
    jpi = _jax_pretrain_ict()
    monkeypatch.setattr(jpi, "args_to_configs", _fp32(jpi, jnp.float32))
    # the entry builds its configs through pretrain_bert.entry_configs
    monkeypatch.setattr(pretrain_bert, "args_to_configs",
                        _fp32(pretrain_bert, torch.float32))
    vocab, data, titles = ict_corpus(tmp_path)
    base = ICT_ARGV.split() + tower_flags.split() + [
        "--vocab_file", vocab, "--data_path", data, "--titles_data_path",
        titles]
    jdir, pdir = str(tmp_path / "jax_ck"), str(tmp_path / "port_ck")

    first = []
    _record(monkeypatch, JaxTrainer, first)
    # one save, committed before the entry returns
    jax_saves_once_committed(monkeypatch, JaxTrainer)
    jpi.main(base + ["--train_iters", "3", "--save", jdir])
    assert [r[0] for r in first] == [1, 2, 3]

    from megatron_llm_tpu import arguments as jax_args

    shared = "--biencoder_shared_query_context_model" in tower_flags
    proj = 16 if "--biencoder_projection_dim" in tower_flags else 0
    jargs, _ = jax_args.build_base_parser().parse_known_args(
        ICT_ARGV.split() + ["--vocab_file", vocab, "--data_path", data])
    jargs.model_name = "bert"
    tok = jax_tok("BertWordPieceLowerCase", vocab_file=vocab,
                  make_vocab_size_divisible_by=8)
    mcfg = dataclasses.replace(
        jpi.args_to_configs(jargs, tok.vocab_size)[0],
        add_binary_head=False)
    tmpl = JaxBiEncoder(mcfg, projection_dim=proj,
                        shared_query_context_model=shared).init(
        jax.random.key(0))
    opt_tmpl = jax_init_opt(tmpl, JaxTrainConfig())
    params, opt, meta, it = jax_load_listing(jax_ckpt.load_checkpoint,
                                             jdir, tmpl, opt_tmpl, mcfg)
    assert it == 3
    checkpoint_from_jax(jax.tree.map(np.asarray, params),
                        jax.tree.map(np.asarray, opt), meta, pdir)

    argv = base + ["--train_iters", "6"]
    jax_run, port_run = [], []
    _record(monkeypatch, JaxTrainer, jax_run)
    jpi.main(argv + ["--load", jdir])
    _record(monkeypatch, Trainer, port_run)
    state = pretrain_ict.main(argv + ["--load", pdir], device="cpu")

    assert state.iteration == 6 and state.consumed_train_samples == 24
    assert [r[0] for r in port_run] == [r[0] for r in jax_run] == [4, 5, 6]
    for (_, jl, jt, jc), (pi, pl, pt, pc) in zip(jax_run, port_run):
        assert set(pt) == set(jt) == set(pretrain_ict.ICT_KEYS)
        for k in jt:
            np.testing.assert_array_equal(pt[k], jt[k], err_msg=k)
        assert pc == jc
        assert abs(pl - jl) <= 1e-5, (pi, pl, jl)
    assert len({round(r[1], 6) for r in port_run}) == 3
    assert set(state.params) == ({"shared"} if shared
                                 else {"query", "context"})


# tp, SP and dp run under torchrun (tests/test_torch_encoder_parallel.py):
# one process without a process group refuses their layouts; pp is
# refused with the JAX entry's message
@pytest.mark.parametrize("flags,error,match", [
    ("--tensor_model_parallel_size 2", RuntimeError, "process group"),
    ("--tensor_model_parallel_size 2 --sequence_parallel", RuntimeError,
     "process group"),
    ("--data_parallel_size 2", RuntimeError, "process group"),
    ("--pipeline_model_parallel_size 2", ValueError, "encoder pretraining: pp>1"),
])
def test_entry_refuses_the_parallel_layouts(tmp_path, flags, error, match):
    vocab, data, titles = ict_corpus(tmp_path, n_docs=8)
    argv = ICT_ARGV.replace("--data_parallel_size 1", "").split() + [
        "--vocab_file", vocab, "--data_path", data, "--titles_data_path",
        titles, "--train_iters", "1", *flags.split()]
    with pytest.raises(error, match=match):
        pretrain_ict.main(argv, device="cpu")


def test_entry_refuses_context_parallelism(tmp_path):
    vocab, data, titles = ict_corpus(tmp_path, n_docs=8)
    argv = ICT_ARGV.split() + [
        "--vocab_file", vocab, "--data_path", data, "--titles_data_path",
        titles, "--train_iters", "1", "--context_parallel_size", "2"]
    with pytest.raises(SystemExit, match="padding masks"):
        pretrain_ict.main(argv, device="cpu")
