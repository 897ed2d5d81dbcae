"""PyTorch port, T5 against the JAX package's, on the CPU in fp32 at
tiny widths (2 layers a side, hidden 64):

- `T5Model`'s logits within 1e-4 (padded decoder rows included, whose
  self-attention row is fully masked: finite, as JAX's) and the loss
  within 1e-5, with and without biases;
- every gradient leaf within 1e-5 (the tied word embeddings' too:
  encoder and decoder lookups plus the head) under every recompute
  policy, with and without biases;
- `cross_attention_block` alone, with a fully masked row;
- the JAX behaviour tests mirrored (tests/test_bert_t5.py:105-190): the
  decoder is causal, cross-attention couples the encoder, encoder
  padding isolates, and `enc_hidden_states` reuses an encoder output;
- under dropout a recomputed decoder layer redraws its masks: the
  gradients under "full" and "selective" equal those without recompute;
- the parameter tree's leaf names and shapes are the JAX package's, and
  `checkpoint_from_jax` carries every T5 leaf;
- `--model_name t5` builds the JAX preset's config;
- entry parity: the JAX `pretrain_t5.main` trains 0 -> 3 and saves; that
  save, restored by the JAX loader and written by `checkpoint_from_jax`,
  resumes the port's `pretrain_t5.main` 3 -> 6 beside the JAX entry
  resuming its own: the same batches, losses within 1e-5 (fp32,
  dropout 0);
- `pretrain_t5.main` refuses tp, SP, dp, pp and cp by name.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu import arguments as jax_args
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.config import t5_config as jax_t5_config
from megatron_llm_tpu.models import T5Model as JaxT5
from megatron_llm_tpu.models.attention import (
    cross_attention_block as jax_cross,
)
from megatron_llm_tpu.models.attention import padding_mask_2d as jax_pad
from megatron_llm_tpu.optimizer import init_optimizer_state as jax_init_opt
from megatron_llm_tpu.tokenizer import build_tokenizer as jax_tok
from megatron_llm_tpu.training import checkpointing as jax_ckpt
from megatron_llm_tpu.training.trainer import Trainer as JaxTrainer
from megatron_llm_tpu_torch import arguments as port_args
from megatron_llm_tpu_torch import pretrain_bert, pretrain_t5
from megatron_llm_tpu_torch.config import t5_config
from megatron_llm_tpu_torch.convert.from_jax import (
    checkpoint_from_jax,
    params_from_jax,
)
from megatron_llm_tpu_torch.models import T5Model
from megatron_llm_tpu_torch.models.attention import (
    cross_attention_block,
    padding_mask_2d,
)
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
            seq_length=24, decoder_seq_length=12, vocab_size=120,
            hidden_dropout=0.0, attention_dropout=0.0)
B, SE, SD = 3, 24, 12
POLICIES = ("none", "full", "selective", "save_dots", "offload")


@pytest.fixture(autouse=True)
def _jax_helpers_loaded():
    """The JAX native helpers loaded in this worker, where a concurrent
    rebuild of a stale library left a failed load behind
    (torch_parity.jax_native_helpers)."""
    jax_native_helpers()


def cfgs(**kw):
    kw = {**TINY, **kw}
    return (jax_t5_config(compute_dtype=jnp.float32, **kw),
            t5_config(compute_dtype=torch.float32, **kw))


def jitter(tree, seed):
    """Every leaf moved by N(0, 0.05): LayerNorm scales and zero biases
    away from their init, so that each gradient term is exercised."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32), tree)


def pair(seed=0, **kw):
    jc, pc = cfgs(**kw)
    jm, pm = JaxT5(jc), T5Model(pc, device="cpu")
    jp = jitter(jm.init(jax.random.key(seed)), seed)
    return jm, jp, pm, params_from_jax(jp, pc, device="cpu")


def batch(seed, vocab=120, enc_keep=(24, 15, 7), dec_keep=(12, 8, 3)):
    rs = np.random.RandomState(seed)
    em = (np.arange(SE)[None] < np.array(enc_keep)[:, None]).astype(
        np.int32)
    dm = (np.arange(SD)[None] < np.array(dec_keep)[:, None]).astype(
        np.int32)
    return dict(
        encoder_input_ids=rs.randint(0, vocab, (B, SE)).astype(np.int32),
        decoder_input_ids=rs.randint(0, vocab, (B, SD)).astype(np.int32),
        lm_labels=rs.randint(0, vocab, (B, SD)).astype(np.int32),
        loss_mask=dm.astype(np.float32),
        encoder_attn_mask=em, decoder_attn_mask=dm)


FWD = ("encoder_input_ids", "decoder_input_ids", "encoder_attn_mask",
       "decoder_attn_mask")


def forward_both(jm, jp, pm, pp, b):
    jl, je = jm.forward(jp, **{k: jnp.asarray(b[k]) for k in FWD})
    with torch.no_grad():
        pl, pe = pm.forward(pp, **{k: t(b[k]) for k in FWD})
    return jl, je, pl, pe


def grads_both(jm, jp, pm, pp, b, **kw):
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(
        p, **{k: jnp.asarray(v) for k, v in b.items()}))(jp)
    for leaf in tree_leaves(pp):
        leaf.requires_grad_(True)
    ploss = pm.loss(pp, **{k: t(v) for k, v in b.items()}, **kw)
    ploss.backward()
    return jloss, jgrads, ploss.detach()


def leaf_at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("use_bias", [True, False])
def test_logits_and_loss_match_the_jax_model(use_bias):
    jm, jp, pm, pp = pair(use_bias=use_bias)
    b = batch(1)
    jl, je, pl, pe = forward_both(jm, jp, pm, pp, b)
    assert pl.shape == (B, SD, pm.cfg.padded_vocab_size)
    assert torch.isfinite(pl).all()
    close(pl, jl, 1e-4)
    close(pe, je, 1e-5)
    jloss = jm.loss(jp, **{k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        ploss = pm.loss(pp, **{k: t(v) for k, v in b.items()})
    assert abs(float(ploss) - float(jloss)) <= 1e-5


@pytest.mark.parametrize("policy,use_bias", [
    *[(p, True) for p in POLICIES], ("none", False), ("full", False)])
def test_every_gradient_matches_the_jax_model(policy, use_bias):
    jm, jp, pm, pp = pair(seed=2, use_bias=use_bias)
    # JAX keeps the selective set where the port offloads it: the same
    # values either way
    jm.cfg = dataclasses.replace(
        jm.cfg, remat_policy="selective" if policy == "offload" else policy)
    pm.cfg = dataclasses.replace(pm.cfg, remat_policy=policy)
    b = batch(3)
    jloss, jgrads, ploss = grads_both(jm, jp, pm, pp, b)
    assert abs(float(ploss) - float(jloss)) <= 1e-5
    flat_j = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat_j) == len(tree_leaves(pp))
    for path, g in flat_j:
        close(leaf_at(pp, path).grad, g, 1e-5,
              msg=jax.tree_util.keystr(path))
    # the tied table takes the two lookups and the head
    emb = pp["embedding"]["word_embeddings"].grad
    assert float(emb.abs().sum()) > 0


def test_cross_attention_block_matches_the_jax_block():
    jc, pc = cfgs()
    jm, jp, _, pp = pair(seed=4)
    one_j = jax.tree.map(lambda a: a[0],
                         jp["decoder_layers"]["cross_attention"])
    one_p = {k: v[0] for k, v in
             pp["decoder_layers"]["cross_attention"].items()}
    rs = np.random.RandomState(5)
    hid = rs.standard_normal((B, SD, 64)).astype(np.float32)
    enc = rs.standard_normal((B, SE, 64)).astype(np.float32)
    dm = batch(6)["decoder_attn_mask"]
    em = batch(6)["encoder_attn_mask"]
    want = jax_cross(one_j, jc, jnp.asarray(hid), jnp.asarray(enc),
                     jax_pad(jnp.asarray(dm), jnp.asarray(em)))
    mask = padding_mask_2d(t(dm), t(em))
    np.testing.assert_array_equal(
        np.asarray(mask), np.asarray(jax_pad(jnp.asarray(dm),
                                             jnp.asarray(em))))
    assert bool(mask[2, 0, 5:].all())  # padded decoder rows: fully masked
    with torch.no_grad():
        got = cross_attention_block(one_p, pc, t(hid), t(enc), mask)
    assert torch.isfinite(got).all()
    close(got, want, 1e-5)


def test_decoder_is_causal():
    """A decoder token changes no logit before its position."""
    jm, jp, pm, pp = pair(seed=7)
    b = batch(8, dec_keep=(12, 12, 12))
    other = dict(b)
    dec = b["decoder_input_ids"].copy()
    dec[:, 6] = (dec[:, 6] + 1) % 120
    other["decoder_input_ids"] = dec
    res = []
    for bb in (b, other):
        jl, _, pl, _ = forward_both(jm, jp, pm, pp, bb)
        close(pl, jl, 1e-4)
        res.append(pl.numpy())
    close(res[0][:, :6], res[1][:, :6], 1e-6)
    assert np.abs(res[0][:, 6:] - res[1][:, 6:]).max() > 1e-4


def test_cross_attention_couples_the_encoder():
    jm, jp, pm, pp = pair(seed=9)
    b = batch(10)
    other = dict(b, encoder_input_ids=(b["encoder_input_ids"] + 1) % 120)
    res = []
    for bb in (b, other):
        jl, _, pl, _ = forward_both(jm, jp, pm, pp, bb)
        close(pl, jl, 1e-4)
        res.append(pl.numpy())
    assert np.abs(res[0] - res[1]).max() > 1e-3


def test_encoder_padding_isolates():
    """Encoder ids under the padding mask move no kept decoder row's
    logits and no kept encoder position. (A padded decoder row's cross
    mask is all masked, so its uniform attention reads every encoder
    column, in both packages alike.)"""
    jm, jp, pm, pp = pair(seed=11)
    b = batch(12)
    keep = b["encoder_attn_mask"].astype(bool)
    enc = b["encoder_input_ids"].copy()
    enc[~keep] = np.random.RandomState(13).randint(0, 120, int((~keep).sum()))
    other = dict(b, encoder_input_ids=enc)
    res = []
    for bb in (b, other):
        jl, _, pl, pe = forward_both(jm, jp, pm, pp, bb)
        close(pl, jl, 1e-4)
        res.append((pl.numpy(), pe.numpy()))
    rows = b["decoder_attn_mask"].astype(bool)
    close(res[0][0][rows], res[1][0][rows], 1e-5)
    close(res[0][1][keep], res[1][1][keep], 1e-5)


def test_enc_hidden_states_reuse_the_encoder_output():
    jm, jp, pm, pp = pair(seed=14)
    b = batch(15)
    _, _, pl, pe = forward_both(jm, jp, pm, pp, b)
    with torch.no_grad():
        again, out = pm.forward(pp, **{k: t(b[k]) for k in FWD},
                                enc_hidden_states=pe)
    assert out is pe
    torch.testing.assert_close(again, pl, rtol=0, atol=0)


@pytest.mark.parametrize("policy", ["full", "selective"])
def test_recomputed_decoder_layers_redraw_their_dropout_masks(policy):
    """With hidden and attention dropout live, the gradients under a
    recompute policy equal those without it: each recomputed layer
    derives the same seeds (the dropout masks are the port's, not
    jax.random's, so this is held within the port)."""
    _, _, pm, pp = pair(seed=16, hidden_dropout=0.1, attention_dropout=0.1)
    b = batch(17)
    grads = {}
    for pol in ("none", policy):
        pm.cfg = dataclasses.replace(pm.cfg, remat_policy=pol)
        for leaf in tree_leaves(pp):
            leaf.grad = None
            leaf.requires_grad_(True)
        loss = pm.loss(pp, **{k: t(v) for k, v in b.items()},
                       dropout_rng=1234, deterministic=False)
        loss.backward()
        grads[pol] = [leaf.grad.clone() for leaf in tree_leaves(pp)]
    for a, c in zip(grads["none"], grads[policy]):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-6)
    with torch.no_grad():
        plain = pm.loss(pp, **{k: t(v) for k, v in b.items()})
    assert abs(float(plain) - float(loss.detach())) > 1e-4  # masks live


def test_parameter_tree_is_the_jax_tree(tmp_path):
    jm, jp, pm, pp = pair(seed=18)
    meta = pm.abstract_params()
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(tree_leaves(meta))
    for path, a in flat_j:
        assert tuple(leaf_at(meta, path).shape) == a.shape, path
    names = {jax.tree_util.keystr(p) for p, _ in flat_j}
    for key in ("['decoder_layers']['cross_attention']['wkv']",
                "['decoder_layers']['cross_attention']['bq']",
                "['decoder_layers']['post_cross_norm']['scale']",
                "['decoder_final_norm']['bias']", "['lm_head_bias']"):
        assert key in names
    # the port's own init draws the same tree on the CPU
    own = pm.init(seed=3)
    assert [tuple(x.shape) for x in tree_leaves(own)] == \
        [tuple(x.shape) for x in tree_leaves(meta)]


def test_checkpoint_from_jax_carries_every_t5_leaf(tmp_path):
    jm, jp, pm, _ = pair(seed=19)
    cfg = jm.cfg
    meta = {"iteration": 7, "consumed_train_samples": 56,
            "config": {"kv_channels": cfg.kv_channels,
                       "num_attention_heads": cfg.num_attention_heads,
                       "num_attention_heads_kv":
                           cfg.num_attention_heads_kv}}
    checkpoint_from_jax(jp, None, meta, str(tmp_path))
    assert read_tracker(str(tmp_path)) == (7, False)
    params, _, _, it = load_checkpoint(str(tmp_path), pm.abstract_params(),
                                       None, pm.cfg, device="cpu",
                                       no_load_optim=True)
    assert it == 7
    for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]:
        np.testing.assert_array_equal(leaf_at(params, path).numpy(),
                                      np.asarray(a))


def test_model_name_t5_builds_the_jax_preset():
    argv = ("--model_name t5 --num_layers 3 --hidden_size 96 "
            "--num_attention_heads 6 --seq_length 40 "
            "--max_position_embeddings 40").split()
    jc = jax_args.args_to_configs(
        jax_args.build_base_parser().parse_args(argv), 1000)[0]
    pc = port_args.args_to_configs(
        port_args.build_base_parser().parse_args(argv), 1000)[0]
    for f in ("num_layers", "hidden_size", "num_attention_heads",
              "seq_length", "max_position_embeddings", "padded_vocab_size",
              "hidden_act", "use_rms_norm", "use_bias", "tie_embed_logits",
              "position_embedding_type", "num_tokentypes",
              "ffn_hidden_size", "kv_channels"):
        assert getattr(pc, f) == getattr(jc, f), f
    T5Model(pc, device="cpu")


# ---------------------------------------------------------------------------
# entry parity: pretrain_t5
# ---------------------------------------------------------------------------


def _jax_pretrain_t5():
    spec = importlib.util.spec_from_file_location(
        "jax_pretrain_t5_entry", os.path.join(REPO, "pretrain_t5.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _no_jax_context_left():
    yield
    from megatron_llm_tpu.parallel.mesh import destroy_parallel

    destroy_parallel()


def t5_corpus(tmp_path, n_docs=60, seed=0):
    """A WordPiece vocabulary and a sentence-split indexed corpus built
    by the JAX package's builder: (vocab file, corpus prefix)."""
    from megatron_llm_tpu.data import indexed_dataset as jax_idx

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"w{i}" for i in range(80)] + [f"##p{i}" for i in range(30)]
    vpath = tmp_path / "vocab.txt"
    vpath.write_text("\n".join(vocab) + "\n")
    rs = np.random.RandomState(seed)
    prefix = str(tmp_path / "t5_text_sentence")
    b = jax_idx.MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    for _ in range(n_docs):
        for _ in range(rs.randint(2, 6)):
            b.add_item(rs.randint(5, len(vocab), rs.randint(3, 12)))
        b.end_document()
    b.finalize(prefix + ".idx")
    return str(vpath), prefix


T5_ARGV = ("--num_layers 2 --hidden_size 64 --num_attention_heads 4 "
           "--seq_length 32 --decoder_seq_length 16 --micro_batch_size 2 "
           "--global_batch_size 4 --lr 1e-3 --lr_decay_style linear "
           "--lr_warmup_iters 1 --tokenizer_type BertWordPieceLowerCase "
           "--split 90,10,0 --eval_interval 3 --eval_iters 1 "
           "--log_interval 1 --hidden_dropout 0 --attention_dropout 0 "
           "--data_parallel_size 1 --seed 5 --vocab_extra_ids 10 "
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
    jpt = _jax_pretrain_t5()
    monkeypatch.setattr(jpt, "args_to_configs", _fp32(jpt, jnp.float32))
    # the entry builds its configs through pretrain_bert.entry_configs
    monkeypatch.setattr(pretrain_bert, "args_to_configs",
                        _fp32(pretrain_bert, torch.float32))
    vocab, data = t5_corpus(tmp_path)
    base = T5_ARGV.split() + ["--vocab_file", vocab, "--data_path", data]
    jdir, pdir = str(tmp_path / "jax_ck"), str(tmp_path / "port_ck")

    first = []
    _record(monkeypatch, JaxTrainer, first)
    # one save, committed before the entry returns
    jax_saves_once_committed(monkeypatch, JaxTrainer)
    jpt.main(base + ["--train_iters", "3", "--save", jdir])
    assert [r[0] for r in first] == [1, 2, 3]

    argv = base + ["--train_iters", "6"]
    jargs, _ = jpt.build_base_parser().parse_known_args(argv)
    jargs.model_name = "t5"
    tok = jax_tok("BertWordPieceLowerCase", vocab_file=vocab,
                  make_vocab_size_divisible_by=8, vocab_extra_ids=10)
    mcfg = jpt.args_to_configs(jargs, tok.vocab_size)[0]
    model = JaxT5(mcfg)
    tmpl = model.init(jax.random.key(0))
    opt_tmpl = jax_init_opt(tmpl, JaxTrainConfig())
    params, opt, meta, it = jax_load_listing(jax_ckpt.load_checkpoint,
                                             jdir, tmpl, opt_tmpl, mcfg)
    assert it == 3
    checkpoint_from_jax(jax.tree.map(np.asarray, params),
                        jax.tree.map(np.asarray, opt), meta, pdir)

    jax_run, port_run = [], []
    _record(monkeypatch, JaxTrainer, jax_run)
    jpt.main(argv + ["--load", jdir])
    _record(monkeypatch, Trainer, port_run)
    state = pretrain_t5.main(argv + ["--load", pdir], device="cpu")

    assert state.iteration == 6 and state.consumed_train_samples == 24
    assert [r[0] for r in port_run] == [r[0] for r in jax_run] == [4, 5, 6]
    for (_, jl, jt, jc), (pi, pl, pt, pc) in zip(jax_run, port_run):
        assert set(pt) == set(jt) == set(pretrain_t5.T5_KEYS)
        for k in jt:
            np.testing.assert_array_equal(pt[k], jt[k], err_msg=k)
        assert pc == jc
        assert abs(pl - jl) <= 1e-5, (pi, pl, jl)
    assert len({round(r[1], 6) for r in port_run}) == 3
    # the decoder side is --decoder_seq_length long
    assert port_run[0][2]["text_dec"].shape[-1] == 16


# tp, SP and dp run under torchrun (tests/test_torch_encoder_parallel.py):
# one process without a process group refuses their layouts; pp is
# refused with the JAX entry's message
@pytest.mark.parametrize("flags,error,match", [
    ("--tensor_model_parallel_size 2", RuntimeError, "process group"),
    ("--tensor_model_parallel_size 2 --sequence_parallel", RuntimeError,
     "process group"),
    ("--data_parallel_size 2", RuntimeError, "process group"),
    ("--pipeline_model_parallel_size 2", ValueError, "encoder-decoder pretraining: pp>1"),
])
def test_entry_refuses_the_parallel_layouts(tmp_path, flags, error, match):
    vocab, data = t5_corpus(tmp_path, n_docs=8)
    argv = T5_ARGV.replace("--data_parallel_size 1", "").split() + [
        "--vocab_file", vocab, "--data_path", data, "--train_iters", "1",
        *flags.split()]
    with pytest.raises(error, match=match):
        pretrain_t5.main(argv, device="cpu")


def test_entry_refuses_context_parallelism(tmp_path):
    vocab, data = t5_corpus(tmp_path, n_docs=8)
    argv = T5_ARGV.split() + ["--vocab_file", vocab, "--data_path", data,
                              "--train_iters", "1",
                              "--context_parallel_size", "2"]
    with pytest.raises(SystemExit, match="padding masks"):
        pretrain_t5.main(argv, device="cpu")
