"""PyTorch port, dropout (models/dropout.py and its sites) against the JAX
package on the CPU, in fp32.

The port's masks come from torch generators seeded from derived
streams, not from jax.random, so the layer math is held with the same
masks fed to both sides: `jax.random.bernoulli` and the port's
`dropout.bernoulli` are monkeypatched to hand out the same numpy masks.
- At rate 0 every dropout path is the deterministic path bit for bit.
- A 3-layer stack, serial (Llama) and parallel (Falcon), with attention
  dropout, hidden dropout and LIMA's per-layer rates: its output and
  gradients within 1e-5 of the JAX layers run with the same masks and
  rates. (The JAX stack itself raises under LIMA while training: its
  scanned layer index is traced and `_dropout` branches on the rate.)
- The whole model, embedding dropout included, against the JAX model,
  with masks keyed by shape and rate (the JAX stack traces its layer
  once, so every layer draws the same masks there).
- Statistics: the keep rate within binomial bounds, kept values scaled
  by 1 / (1 - rate), distinct streams drawing distinct masks.
- With attention dropout live the flash path is not taken.
- Full and selective recompute give the gradients of no recompute at
  the same seed: the recompute draws the same masks.
- A run resumed from a checkpoint draws the masks of an uninterrupted
  one (the base seed travels in the checkpoint; --no_load_rng drops it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import falcon_config as jax_falcon_config
from megatron_llm_tpu.config import tiny_config as jax_tiny_config
from megatron_llm_tpu.models import FalconModel as JaxFalcon
from megatron_llm_tpu.models import LlamaModel as JaxLlama
from megatron_llm_tpu.models import transformer as jax_tf
from megatron_llm_tpu.models.rope import precompute_rope as jax_rope
from megatron_llm_tpu_torch.config import ParallelConfig, TrainConfig
from megatron_llm_tpu_torch.config import falcon_config
from megatron_llm_tpu_torch.config import tiny_config as torch_tiny_config
from megatron_llm_tpu_torch.convert.from_jax import params_from_jax
from megatron_llm_tpu_torch.models import FalconModel, LlamaModel
from megatron_llm_tpu_torch.models import dropout as dr
from megatron_llm_tpu_torch.models import transformer as pt_tf
from megatron_llm_tpu_torch.models.rope import precompute_rope
from megatron_llm_tpu_torch.ops import flash_attention as fa
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
from megatron_llm_tpu_torch.training.checkpointing import (
    flatten,
    unflatten_like,
)
from megatron_llm_tpu_torch.training.trainer import Trainer
from torch_parity import TINY, close, t

SEQ = 16
RATES = dict(hidden_dropout=0.2, attention_dropout=0.3)


def _pair(kind, **kw):
    """(jax model, jax params, port model, port params), 3 layers, fp32:
    the GQA Llama or a Falcon (parallel attention, MQA)."""
    if kind == "falcon":
        fk = dict(num_layers=3, hidden_size=64, num_attention_heads=8,
                  num_attention_heads_kv=1, ffn_hidden_size=128,
                  seq_length=SEQ, max_position_embeddings=SEQ,
                  vocab_size=256, **kw)
        jm = JaxFalcon(jax_falcon_config(7, compute_dtype=jnp.float32, **fk))
        tm = FalconModel(falcon_config(7, compute_dtype=torch.float32, **fk),
                         device="cpu")
    else:
        lk = dict(TINY, num_layers=3, seq_length=SEQ,
                  max_position_embeddings=SEQ, **kw)
        jm = JaxLlama(jax_tiny_config(**lk, compute_dtype=jnp.float32))
        tm = LlamaModel(torch_tiny_config(**lk, compute_dtype=torch.float32),
                        device="cpu")
    jp = jm.init(jax.random.key(9))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


def _tokens(vocab, seed=3):
    rs = np.random.RandomState(seed)
    data = rs.randint(0, vocab, (2, SEQ + 1)).astype(np.int32)
    return t(data[:, :-1]).long(), t(data[:, 1:]).long()


def _grads(tm, tp, toks, labels, **kw):
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = tm.loss(tp, toks, labels, **kw)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("kind,lima", [("llama", False), ("llama", True),
                                       ("falcon", False)])
def test_rate_zero_is_the_deterministic_path_bitwise(kind, lima):
    _, _, tm, tp = _pair(kind, hidden_dropout=0.0, attention_dropout=0.0,
                         lima_dropout=lima)
    toks, labels = _tokens(tm.cfg.padded_vocab_size)
    ref, gref = _grads(tm, tp, toks, labels)
    got, g = _grads(tm, tp, toks, labels, dropout_rng=123,
                    deterministic=False)
    assert torch.equal(got, ref)
    assert all(torch.equal(a, b) for a, b in zip(g, gref))
    x = torch.randn(5, 7)
    assert dr.dropout(x, 0.0, 5) is x and dr.dropout(x, 0.4, None) is x


class _Masks:
    """Hands the same masks to both packages: `record` draws them from
    numpy for the JAX calls, `replay` gives them back to the port's in
    the same order, checking shape and keep probability."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)
        self.drawn = []

    def record(self, key, p, shape):
        mask = self.rs.rand(*shape) < p
        self.drawn.append((float(p), tuple(shape), mask))
        return jnp.asarray(mask)

    def replay(self):
        it = iter(self.drawn)

        def bernoulli(seed, p, shape, device):
            want_p, want_shape, mask = next(it)
            assert (tuple(shape), p) == (want_shape,
                                         pytest.approx(want_p, abs=1e-7))
            return torch.from_numpy(mask)
        return bernoulli, it


def _layer_inputs(cfg, seed=0):
    rs = np.random.RandomState(seed)
    h = rs.randn(2, SEQ, cfg.hidden_size).astype(np.float32)
    ct = rs.randn(2, SEQ, cfg.hidden_size).astype(np.float32)
    return h, ct


@pytest.mark.parametrize("kind", ["llama", "falcon"])
def test_stack_matches_jax_layers_with_the_same_masks(kind, monkeypatch):
    """Attention and hidden dropout in every layer, LIMA's rates
    hidden_dropout * i / (L - 1): the port's stack against the JAX layers
    run one by one at those rates, on the same masks (layer 0's hidden
    rate is 0, which draws no mask on either side)."""
    jm, jp, tm, tp = _pair(kind, lima_dropout=True, **RATES)
    cfg = tm.cfg
    h, ct = _layer_inputs(cfg)
    L = cfg.num_layers
    rope_j = jax_rope(cfg.head_dim, SEQ, cfg.rope_theta,
                      cfg.rope_scaling_factor)
    masks = _Masks(1)
    monkeypatch.setattr(jax.random, "bernoulli", masks.record)

    def jax_stack(layers, x):
        for i in range(L):
            lp = jax.tree.map(lambda a: a[i], layers)
            x, _ = jax_tf.transformer_layer(
                lp, jm.cfg, x, rope_j, None, None,
                dropout_rng=jax.random.key(i), deterministic=False,
                hidden_dropout_rate=RATES["hidden_dropout"] * i / (L - 1))
        return jnp.sum(x * jnp.asarray(ct)), x

    (_, jout), jg = jax.value_and_grad(jax_stack, argnums=(0, 1),
                                       has_aux=True)(jp["layers"],
                                                     jnp.asarray(h))
    # attention dropout in each layer; hidden dropout (two sites in a
    # serial layer, one in a parallel one) from layer 1 on
    hidden_sites = 1 if cfg.parallel_attn else 2
    assert len(masks.drawn) == L + hidden_sites * (L - 1)
    bern, left = masks.replay()
    monkeypatch.setattr(dr, "bernoulli", bern)
    rope = precompute_rope(cfg.head_dim, SEQ, cfg.rope_theta,
                           cfg.rope_scaling_factor, "cpu")
    leaves = tree_leaves(tp["layers"])
    for leaf in leaves:
        leaf.requires_grad_(True)
    x = t(h).requires_grad_(True)
    out, _ = pt_tf.transformer_stack(tp["layers"], cfg, x, rope,
                                     dropout_seed=77)
    grads = torch.autograd.grad((out * t(ct)).sum(), [x] + leaves)
    assert next(left, None) is None  # every mask used, in order
    close(out.detach().numpy(), np.asarray(jout), 1e-5, "out")
    close(grads[0].numpy(), np.asarray(jg[1]), 1e-5, "d hidden")
    jflat = jax.tree.leaves(jax.tree.map(np.asarray, jg[0]))
    for a, b in zip(grads[1:], jflat, strict=True):
        close(a.numpy(), b, 1e-5)


def test_model_matches_jax_with_masks_keyed_by_shape(monkeypatch):
    """The whole loss and its gradients, embedding dropout included, on
    masks keyed by (shape, keep probability): the JAX stack traces one
    layer for all, so all its layers share a site's mask; the port's
    draw the same."""
    jm, jp, tm, tp = _pair("llama", **RATES)
    toks, labels = _tokens(tm.cfg.padded_vocab_size)
    rs = np.random.RandomState(2)
    cache = {}

    def mask(p, shape):
        key = (round(float(p), 6), tuple(shape))
        if key not in cache:
            cache[key] = rs.rand(*shape) < p
        return cache[key]

    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda k, p, shape: jnp.asarray(mask(p, shape)))
    jl, jg = jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(toks.numpy()), jnp.asarray(labels.numpy()),
        dropout_rng=jax.random.key(0), deterministic=False))(jp)
    assert len(cache) == 2  # the hidden and the attention-probs shapes
    monkeypatch.setattr(dr, "bernoulli", lambda s, p, shape, device:
                        torch.from_numpy(mask(p, shape)))
    loss, grads = _grads(tm, tp, toks, labels, dropout_rng=5,
                         deterministic=False)
    close(loss.item(), float(jl), 1e-6, "loss")
    for a, b in zip(grads, jax.tree.leaves(jax.tree.map(np.asarray, jg)),
                    strict=True):
        close(a.numpy(), b, 1e-5)


def test_keep_rate_scaling_and_distinct_streams():
    n, rate = 1_000_000, 0.1
    keep = dr.bernoulli(dr.fold_in(11, 3), 1 - rate, (n,), "cpu")
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(keep.float().mean().item() - (1 - rate)) < 5 * sigma
    x = torch.ones(1000, 100)
    y = dr.dropout(x, 0.25, 42)
    assert set(torch.unique(y).tolist()) == {
        0.0, float(torch.tensor(1 / 0.75, dtype=torch.float32))}
    assert torch.equal(y, dr.dropout(x, 0.25, 42))  # a seed is a mask
    # layers, microbatches, iterations and the three sites of a layer
    # each draw their own masks
    seeds = {dr.fold_in(7, i) for i in range(64)}
    seeds |= {s for i in range(64) for s in dr.split(dr.fold_in(7, i), 3)}
    assert len(seeds) == 64 * 4
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert not torch.equal(dr.dropout(x, 0.25, 1), dr.dropout(x, 0.25, 2))


def test_attention_dropout_takes_the_grouped_path(monkeypatch):
    calls = []
    inner = fa._fwd
    monkeypatch.setattr(fa, "_fwd", lambda *a: calls.append(1) or inner(*a))
    _, _, tm, tp = _pair("llama", use_flash_attn=True, **RATES)
    toks, labels = _tokens(tm.cfg.padded_vocab_size)
    with torch.no_grad():
        tm.loss(tp, toks, labels)  # deterministic: flash
        assert len(calls) == tm.cfg.num_layers
        tm.loss(tp, toks, labels, dropout_rng=1, deterministic=False)
        assert len(calls) == tm.cfg.num_layers  # grouped path: no flash
    _, _, hm, hp = _pair("llama", use_flash_attn=True, hidden_dropout=0.2,
                         attention_dropout=0.0)
    with torch.no_grad():
        hm.loss(hp, toks, labels, dropout_rng=1, deterministic=False)
    assert len(calls) == 2 * tm.cfg.num_layers  # hidden dropout only


@pytest.mark.parametrize("policy", ["full", "selective", "offload"])
@pytest.mark.parametrize("kind", ["llama", "falcon"])
def test_recompute_draws_the_same_masks(kind, policy):
    """Gradients under recompute equal those without, at the same
    dropout seed, bit for bit: the recomputed layer draws the same
    masks (a mask drawn from an advancing generator would not)."""
    base = dict(use_flash_attn=True, lima_dropout=True, **RATES)
    _, _, none_m, tp = _pair(kind, remat_policy="none", **base)
    _, _, re_m, _ = _pair(kind, remat_policy=policy, **base)
    toks, labels = _tokens(none_m.cfg.padded_vocab_size)
    ref, gref = _grads(none_m, tp, toks, labels, dropout_rng=31,
                       deterministic=False)
    got, g = _grads(re_m, tp, toks, labels, dropout_rng=31,
                    deterministic=False)
    assert torch.equal(got, ref)
    assert all(torch.equal(a, b) for a, b in zip(g, gref))
    other, _ = _grads(re_m, tp, toks, labels, dropout_rng=32,
                      deterministic=False)
    assert not torch.equal(other, ref)


TRAIN = dict(micro_batch_size=2, global_batch_size=4, lr=1e-3,
             lr_decay_style="constant", train_iters=4, log_interval=100,
             eval_interval=0, clip_grad=1.0, seed=5)


def _batches():
    rs = np.random.RandomState(8)
    return [rs.randint(0, 256, (2, 2, SEQ + 1)).astype(np.int32)
            for _ in range(4)]


def _run(tm, tp, tcfg, batches, iteration=0):
    trainer = Trainer(tm, tcfg, ParallelConfig(num_microbatches=2),
                      train_data_iterator=iter(batches))
    state = trainer.setup(params=tp)
    assert state.iteration == iteration
    trainer.train(state)
    return [e["loss"] for e in trainer.recorder.snapshot()["events"]
            if e["kind"] == "step"], trainer


@pytest.mark.parametrize("no_load_rng", [False, True])
def test_resume_draws_the_masks_of_an_uninterrupted_run(tmp_path,
                                                        no_load_rng):
    """4 steps straight, and 2 steps saved then 2 resumed from the
    checkpoint under another --seed: the resumed losses equal the
    uninterrupted ones bit for bit, because the base seed comes back
    from the checkpoint; with --no_load_rng the resume takes its own
    seed + 1 and draws other masks."""
    _, _, tm, tp = _pair("llama", remat_policy="full", **RATES)
    init = {k: v.detach().clone() for k, v in flatten(tp).items()}

    def fresh():
        return unflatten_like({k: v.clone() for k, v in init.items()}, tp)
    straight, _ = _run(tm, fresh(), TrainConfig(**TRAIN), _batches())
    save = str(tmp_path / "ck")
    first, tr = _run(tm, fresh(), TrainConfig(**dict(
        TRAIN, train_iters=2, save=save, save_interval=2)), _batches()[:2])
    assert tr._dropout_seed == TRAIN["seed"] + 1
    assert first == straight[:2]
    resumed, tr = _run(tm, fresh(), TrainConfig(**dict(
        TRAIN, seed=99, load=save, no_load_rng=no_load_rng)),
        _batches()[2:], iteration=2)
    if no_load_rng:
        assert tr._dropout_seed == 100
        assert resumed != straight[2:]
    else:
        assert tr._dropout_seed == TRAIN["seed"] + 1
        assert resumed == straight[2:]
