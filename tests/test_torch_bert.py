"""PyTorch port, the BERT encoder against the JAX package's, on the CPU
in fp32 at tiny widths (2 layers, hidden 64):

- `BertModel`'s LM and binary logits within 1e-4, the loss (masked LM +
  sentence order) and every gradient within 1e-5, with and without the
  binary head, pre-LN and post-LN;
- padding isolation (the ids under the padding mask move nothing that
  is kept) and tokentype dependence, in both packages alike;
- one post-LN layer against the JAX package's post-LN branch;
- `params_from_jax` and `checkpoint_from_jax` carry every leaf of the
  encoder's tree (the LM head, pooler, binary head, tokentypes);
- entry parity: the JAX `pretrain_bert.main` trains 0 -> 3 and saves;
  that save, restored by the JAX loader and written by
  `checkpoint_from_jax`, resumes the port's `pretrain_bert.main` 3 -> 6
  beside the JAX entry resuming its own: the same batches, losses
  within 1e-5 (fp32, dropout 0).
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
from megatron_llm_tpu.models import BertModel as JaxBert
from megatron_llm_tpu.models.attention import padding_mask_2d as jax_pad
from megatron_llm_tpu.models.transformer import (
    init_layer_params as jax_init_layers,
)
from megatron_llm_tpu.models.transformer import (
    transformer_layer as jax_layer,
)
from megatron_llm_tpu.optimizer import init_optimizer_state as jax_init_opt
from megatron_llm_tpu.training import checkpointing as jax_ckpt
from megatron_llm_tpu.training.trainer import Trainer as JaxTrainer
from megatron_llm_tpu_torch import pretrain_bert
from megatron_llm_tpu_torch.config import bert_config
from megatron_llm_tpu_torch.convert.from_jax import (
    checkpoint_from_jax,
    params_from_jax,
)
from megatron_llm_tpu_torch.models import BertModel
from megatron_llm_tpu_torch.models.attention import padding_mask_2d
from megatron_llm_tpu_torch.models.transformer import transformer_layer
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
            attention_dropout=0.0)
B, S = 3, 32


@pytest.fixture(autouse=True)
def _jax_helpers_loaded():
    """The JAX native helpers loaded in this worker, where a concurrent
    rebuild of a stale library left a failed load behind
    (torch_parity.jax_native_helpers)."""
    jax_native_helpers()


def cfgs(**kw):
    kw = {**TINY, **kw}
    return (jax_bert_config(compute_dtype=jnp.float32, **kw),
            bert_config(compute_dtype=torch.float32, **kw))


def jitter(tree, seed):
    """Every leaf moved by N(0, 0.05): LayerNorm scales and zero biases
    away from their init, so that each gradient term is exercised."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32), tree)


def pair(seed=0, **kw):
    jc, pc = cfgs(**kw)
    jm, pm = JaxBert(jc), BertModel(pc, device="cpu")
    jp = jitter(jm.init(jax.random.key(seed)), seed)
    return jm, jp, pm, params_from_jax(jp, pc, device="cpu")


def batch(seed, vocab=120, pad_from=(32, 20, 9)):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, vocab, (B, S)).astype(np.int32)
    keep = (np.arange(S)[None] < np.array(pad_from)[:, None]).astype(
        np.int32)
    types = (np.arange(S)[None] >= np.array([10, 7, 3])[:, None]).astype(
        np.int32)
    labels = rs.randint(0, vocab, (B, S)).astype(np.int32)
    loss_mask = (rs.rand(B, S) < 0.3).astype(np.float32) * keep
    sop = rs.randint(0, 2, (B,)).astype(np.int32)
    return dict(tokens=tokens, attention_mask=keep, tokentype_ids=types,
                labels=labels, loss_mask=loss_mask, sop_labels=sop)


def jax_kw(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_kw(b):
    return {k: t(v) for k, v in b.items()}


FWD = ("tokens", "attention_mask", "tokentype_ids")


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("post_ln", [False, True])
def test_logits_match_the_jax_model(binary, post_ln):
    jm, jp, pm, pp = pair(add_binary_head=binary, use_post_ln=post_ln)
    b = batch(1)
    jl, jb = jm.forward(jp, **{k: jnp.asarray(b[k]) for k in FWD})
    with torch.no_grad():
        pl, pb = pm.forward(pp, **{k: t(b[k]) for k in FWD})
    assert pl.shape == (B, S, pm.cfg.padded_vocab_size)
    close(pl, jl, 1e-4)
    if binary:
        assert pb.shape == (B, 2)
        close(pb, jb, 1e-4)
    else:
        assert pb is None and jb is None


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("post_ln", [False, True])
def test_loss_and_gradients_match_the_jax_model(binary, post_ln):
    jm, jp, pm, pp = pair(seed=2, add_binary_head=binary,
                          use_post_ln=post_ln)
    b = batch(3)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, **jax_kw(b)))(jp)
    for leaf in tree_leaves(pp):
        leaf.requires_grad_(True)
    ploss = pm.loss(pp, **torch_kw(b))
    ploss.backward()
    assert abs(float(ploss.detach()) - float(jloss)) <= 1e-5
    flat_j = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat_j) == len(tree_leaves(pp))
    for path, g in flat_j:
        leaf = pp
        for k in path:
            leaf = leaf[k.key]
        close(leaf.grad, g, 1e-5, msg=jax.tree_util.keystr(path))


def test_padding_isolates_the_kept_positions():
    """Ids under the padding mask change no kept position's logits, and
    the pooled (binary) logits not at all, in either package."""
    jm, jp, pm, pp = pair(seed=4)
    b = batch(5)
    other = dict(b)
    rs = np.random.RandomState(6)
    toks = b["tokens"].copy()
    toks[b["attention_mask"] == 0] = rs.randint(
        0, 120, int((b["attention_mask"] == 0).sum()))
    other["tokens"] = toks
    keep = b["attention_mask"].astype(bool)
    outs = []
    for bb in (b, other):
        jl, jb = jm.forward(jp, **{k: jnp.asarray(bb[k]) for k in FWD})
        with torch.no_grad():
            pl, pb = pm.forward(pp, **{k: t(bb[k]) for k in FWD})
        close(pl, jl, 1e-4)
        outs.append((np.asarray(pl), np.asarray(pb)))
    close(outs[0][0][keep], outs[1][0][keep], 1e-5)
    close(outs[0][1], outs[1][1], 1e-5)
    # the mask is the JAX one
    np.testing.assert_array_equal(
        np.asarray(padding_mask_2d(t(b["attention_mask"]))),
        np.asarray(jax_pad(jnp.asarray(b["attention_mask"]))))


def test_tokentypes_move_the_outputs_as_in_jax():
    jm, jp, pm, pp = pair(seed=7)
    b = batch(8)
    flipped = dict(b, tokentype_ids=1 - b["tokentype_ids"])
    res = []
    for bb in (b, flipped):
        jl, _ = jm.forward(jp, **{k: jnp.asarray(bb[k]) for k in FWD})
        with torch.no_grad():
            pl, _ = pm.forward(pp, **{k: t(bb[k]) for k in FWD})
        close(pl, jl, 1e-4)
        res.append(np.asarray(pl))
    assert np.abs(res[0] - res[1]).max() > 1e-3
    assert "tokentype_embeddings" in pp["embedding"]
    assert tuple(pp["embedding"]["tokentype_embeddings"].shape) == (2, 64)


def test_post_ln_layer_matches_the_jax_branch():
    jc, pc = cfgs(use_post_ln=True)
    jl = jitter(jax_init_layers(jc, jax.random.key(9), num_layers=1), 9)
    one = jax.tree.map(lambda a: a[0], jl)
    x = np.random.RandomState(10).standard_normal((B, S, 64)).astype(
        np.float32)
    keep = batch(11)["attention_mask"]
    jo, _ = jax_layer(one, jc, jnp.asarray(x), None,
                      jax_pad(jnp.asarray(keep)), None)
    layers = params_from_jax({"layers": jl}, pc, device="cpu")["layers"]
    one_p = jax.tree.map(lambda a: a[0], layers)
    with torch.no_grad():
        po, _ = transformer_layer(one_p, pc, t(x), None,
                                  padding_mask_2d(t(keep)), None)
    close(po, jo, 1e-5)
    # and it is not the pre-LN layer
    with torch.no_grad():
        pre, _ = transformer_layer(one_p, dataclasses.replace(
            pc, use_post_ln=False), t(x), None, padding_mask_2d(t(keep)),
            None)
    assert float((pre - po).abs().max()) > 1e-3


def test_checkpoint_from_jax_carries_every_encoder_leaf(tmp_path):
    jm, jp, pm, pp = pair(seed=12)
    cfg = jm.cfg
    meta = {"iteration": 5, "consumed_train_samples": 40,
            "config": {"kv_channels": cfg.kv_channels,
                       "num_attention_heads": cfg.num_attention_heads,
                       "num_attention_heads_kv":
                           cfg.num_attention_heads_kv}}
    checkpoint_from_jax(jp, None, meta, str(tmp_path))
    assert read_tracker(str(tmp_path)) == (5, False)
    params, _, _, it = load_checkpoint(str(tmp_path), pm.abstract_params(),
                                       None, pm.cfg, device="cpu",
                                       no_load_optim=True)
    assert it == 5
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    for key in ("['lm_head']['dense_w']", "['lm_head']['norm']['scale']",
                "['lm_head']['bias']", "['pooler']['w']",
                "['binary_head']['b']",
                "['embedding']['tokentype_embeddings']"):
        assert key in names
    for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]:
        leaf = params
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# entry parity: pretrain_bert
# ---------------------------------------------------------------------------


def _jax_pretrain_bert():
    spec = importlib.util.spec_from_file_location(
        "jax_pretrain_bert_entry", os.path.join(REPO, "pretrain_bert.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _no_jax_context_left():
    yield
    from megatron_llm_tpu.parallel.mesh import destroy_parallel

    destroy_parallel()


def bert_corpus(tmp_path, n_docs=60, seed=0):
    """A WordPiece vocabulary and a sentence-split indexed corpus built
    by the JAX package's builder: (vocab file, corpus prefix)."""
    from megatron_llm_tpu.data import indexed_dataset as jax_idx

    words = [f"w{i}" for i in range(80)]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words + [
        f"##p{i}" for i in range(30)]
    vpath = tmp_path / "vocab.txt"
    vpath.write_text("\n".join(vocab) + "\n")
    rs = np.random.RandomState(seed)
    prefix = str(tmp_path / "bert_text_sentence")
    b = jax_idx.MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    for _ in range(n_docs):
        for _ in range(rs.randint(2, 6)):
            b.add_item(rs.randint(5, len(vocab), rs.randint(3, 12)))
        b.end_document()
    b.finalize(prefix + ".idx")
    return str(vpath), prefix


BERT_ARGV = ("--num_layers 2 --hidden_size 64 --num_attention_heads 4 "
             "--seq_length 32 --micro_batch_size 2 --global_batch_size 4 "
             "--lr 1e-3 --lr_decay_style linear --lr_warmup_iters 1 "
             "--tokenizer_type BertWordPieceLowerCase --split 90,10,0 "
             "--eval_interval 3 --eval_iters 1 --log_interval 1 "
             "--hidden_dropout 0 --attention_dropout 0 "
             "--data_parallel_size 1 --seed 5 "
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


def test_entry_parity_jax_to_port(tmp_path, monkeypatch):
    jpb = _jax_pretrain_bert()
    monkeypatch.setattr(jpb, "args_to_configs", _fp32(jpb, jnp.float32))
    monkeypatch.setattr(pretrain_bert, "args_to_configs",
                        _fp32(pretrain_bert, torch.float32))
    vocab, data = bert_corpus(tmp_path)
    base = BERT_ARGV.split() + ["--vocab_file", vocab, "--data_path", data]
    jdir, pdir = str(tmp_path / "jax_ck"), str(tmp_path / "port_ck")

    first = []
    _record(monkeypatch, JaxTrainer, first)
    # one save, committed before the entry returns
    jax_saves_once_committed(monkeypatch, JaxTrainer)
    jpb.main(base + ["--train_iters", "3", "--save", jdir])
    assert [r[0] for r in first] == [1, 2, 3]

    argv = base + ["--train_iters", "6"]
    from megatron_llm_tpu import arguments as jax_args
    from megatron_llm_tpu.tokenizer import build_tokenizer as jax_tok

    jargs = jax_args.build_base_parser().parse_args(argv)
    jargs.model_name = "bert"
    tok = jax_tok("BertWordPieceLowerCase", vocab_file=vocab,
                  make_vocab_size_divisible_by=8)
    mcfg = jpb.args_to_configs(jargs, tok.vocab_size)[0]
    model = JaxBert(mcfg)
    tmpl = model.init(jax.random.key(0))
    opt_tmpl = jax_init_opt(tmpl, JaxTrainConfig())
    params, opt, meta, it = jax_load_listing(jax_ckpt.load_checkpoint,
                                             jdir, tmpl, opt_tmpl, mcfg)
    assert it == 3
    checkpoint_from_jax(jax.tree.map(np.asarray, params),
                        jax.tree.map(np.asarray, opt), meta, pdir)

    jax_run, port_run = [], []
    _record(monkeypatch, JaxTrainer, jax_run)
    jpb.main(argv + ["--load", jdir])
    _record(monkeypatch, Trainer, port_run)
    state = pretrain_bert.main(argv + ["--load", pdir], device="cpu")

    assert state.iteration == 6 and state.consumed_train_samples == 24
    assert [r[0] for r in port_run] == [r[0] for r in jax_run] == [4, 5, 6]
    for (_, jl, jt, jc), (pi, pl, pt, pc) in zip(jax_run, port_run):
        assert set(pt) == set(jt)
        for k in jt:
            np.testing.assert_array_equal(pt[k], jt[k], err_msg=k)
        assert pc == jc
        assert abs(pl - jl) <= 1e-5, (pi, pl, jl)
    assert len({round(r[1], 6) for r in port_run}) == 3
