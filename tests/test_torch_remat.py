"""PyTorch port, the recompute policies (models/remat.py) against the JAX
package's on the CPU, in fp32.

- For each policy (none, full, selective, save_dots, offload) and each
  recompute method (uniform, and block with 1 of 3 layers), the loss and
  every gradient of a tiny GQA Llama with the flash path equal the JAX
  model's under the same policy: loss within 1e-6, gradients within
  1e-5. Likewise, for a subset, a tiny MHA Llama on the grouped path and
  a tiny Falcon (parallel attention).
- Under selective, save_dots and offload the plain flash forward runs
  once a layer, under full twice: the kept o and lse answer the
  recompute (K4's launches on the card follow the same count).
- What a policy keeps: the products of one layer under selective and
  save_dots, by name and size, against the residuals JAX's
  print_saved_residuals shows for the same layer and policy.
- The Trainer over 3 steps under selective with block recompute against
  the JAX Trainer.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.config import falcon_config as jax_falcon_config
from megatron_llm_tpu.config import tiny_config as jax_tiny_config
from megatron_llm_tpu.models import FalconModel as JaxFalcon
from megatron_llm_tpu.models import LlamaModel as JaxLlama
from megatron_llm_tpu.models import transformer as jax_tf
from megatron_llm_tpu.models.remat import remat_policy_fn
from megatron_llm_tpu.models.rope import precompute_rope as jax_rope
from megatron_llm_tpu.training.trainer import Trainer as JaxTrainer
from megatron_llm_tpu_torch.config import ParallelConfig, TrainConfig
from megatron_llm_tpu_torch.config import falcon_config
from megatron_llm_tpu_torch.config import tiny_config as torch_tiny_config
from megatron_llm_tpu_torch.convert.from_jax import params_from_jax
from megatron_llm_tpu_torch.models import FalconModel, LlamaModel
from megatron_llm_tpu_torch.models import remat
from megatron_llm_tpu_torch.models import transformer as pt_tf
from megatron_llm_tpu_torch.models.rope import precompute_rope
from megatron_llm_tpu_torch.ops import flash_attention as fa
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
from megatron_llm_tpu_torch.training.trainer import Trainer
from torch_parity import TINY, close, jax_cfg, t, torch_cfg

SEQ = 16
POLICIES = ("none", "full", "selective", "save_dots", "offload")
CASES = [(p, "uniform") for p in POLICIES] + \
    [(p, "block") for p in POLICIES if p != "none"]


def _remat(policy, method):
    kw = dict(remat_policy=policy, recompute_method=method)
    if method == "block":
        kw["recompute_num_layers"] = 1
    return kw


def _models(kind, policy, method):
    """(jax model, jax params, port model, port params) for "gqa" (tiny
    Llama, g 2, d 128, flash), "mha" (g 4, grouped path) or "falcon"
    (parallel attention, MQA, flash), 3 layers, fp32."""
    kw = dict(num_layers=3, seq_length=SEQ, max_position_embeddings=SEQ,
              **_remat(policy, method))
    if kind == "falcon":
        fk = dict(num_layers=3, hidden_size=64, num_attention_heads=8,
                  num_attention_heads_kv=1, ffn_hidden_size=128,
                  seq_length=SEQ, max_position_embeddings=SEQ,
                  vocab_size=256, use_flash_attn=True,
                  **_remat(policy, method))
        jm = JaxFalcon(jax_falcon_config(7, compute_dtype=jnp.float32, **fk))
        tm = FalconModel(falcon_config(7, compute_dtype=torch.float32, **fk),
                         device="cpu")
    else:
        kw = dict(TINY, **kw, use_flash_attn=kind == "gqa")
        if kind == "mha":
            kw["num_attention_heads_kv"] = 4
        jm = JaxLlama(jax_tiny_config(**kw, compute_dtype=jnp.float32))
        tm = LlamaModel(torch_tiny_config(**kw, compute_dtype=torch.float32),
                        device="cpu")
    jp = jm.init(jax.random.key(5))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


def _tokens(vocab):
    rs = np.random.RandomState(3)
    data = rs.randint(0, vocab, (2, SEQ + 1)).astype(np.int32)
    return data[:, :-1], data[:, 1:]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _parity(kind, policy, method):
    jm, jp, tm, tp = _models(kind, policy, method)
    toks, labels = _tokens(tm.cfg.padded_vocab_size)
    jl, jg = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(toks), jnp.asarray(labels)))(jp)
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    calls = []
    inner = fa._fwd

    def counting(*a):
        calls.append(1)
        return inner(*a)
    fa._fwd = counting
    try:
        loss = tm.loss(tp, t(toks).long(), t(labels).long())
        loss.backward()
    finally:
        fa._fwd = inner
    close(loss.item(), float(jl), 1e-6, "loss")
    jflat, pflat = _flat(jax.tree.map(np.asarray, jg)), _flat(tp)
    assert set(jflat) == set(pflat)
    for name, g in jflat.items():
        close(pflat[name].grad.numpy(), g, 1e-5, name)
    return len(calls)


@pytest.mark.parametrize("policy,method", CASES)
def test_policy_matches_jax_gqa_flash(policy, method):
    """Loss and gradients of the GQA Llama on the flash path under each
    policy and method; the plain flash forward runs once a layer under
    the named-save-point policies and twice under full (block: the
    remat'd first layer only)."""
    fwd = _parity("gqa", policy, method)
    L, remat_layers = 3, (1 if method == "block" else 3)
    recomputed = remat_layers if policy == "full" else 0
    assert fwd == L + recomputed, (policy, method, fwd)


@pytest.mark.parametrize("kind,policy,method", [
    ("mha", "selective", "uniform"),
    ("mha", "save_dots", "uniform"),
    ("mha", "offload", "block"),
    ("falcon", "selective", "uniform"),
    ("falcon", "offload", "uniform"),
    ("falcon", "full", "block"),
])
def test_policy_matches_jax_mha_and_falcon(kind, policy, method):
    """The grouped attention path (MHA, no flash: its PV product is the
    "attn_ctx" save point) and Falcon's parallel layer."""
    _parity(kind, policy, method)


def _jax_residuals(capsys, policy, flash):
    """Element counts of the residuals print_saved_residuals shows for one
    layer of the GQA Llama under `policy`, arguments and constants left
    out."""
    cfg = jax_cfg(num_layers=2, seq_length=SEQ,
                  max_position_embeddings=SEQ, use_flash_attn=flash)
    jm = JaxLlama(cfg)
    jp = jm.init(jax.random.key(5))
    lp = jax.tree.map(lambda x: x[0], jp["layers"])
    rope = jax_rope(cfg.head_dim, SEQ, cfg.rope_theta,
                    cfg.rope_scaling_factor)
    h = jnp.asarray(np.random.RandomState(0).randn(2, SEQ, cfg.hidden_size),
                    jnp.float32)

    def f(lp, h):
        return jax_tf.transformer_layer(lp, cfg, h, rope, None, None)[0].sum()
    capsys.readouterr()
    jax.ad_checkpoint.print_saved_residuals(
        jax.checkpoint(f, policy=remat_policy_fn(policy)), lp, h)
    sizes = []
    for line in capsys.readouterr().out.splitlines():
        if "from the argument" in line or "from a constant" in line:
            continue
        dims = re.match(r"f32(?:<host>)?\[([\d,]*)\]", line).group(1)
        sizes.append(int(np.prod([int(d) for d in dims.split(",")])))
    return jp, sorted(sizes)


@pytest.mark.parametrize("policy,flash", [("selective", True),
                                          ("selective", False),
                                          ("offload", True),
                                          ("save_dots", False)])
def test_kept_tensors_match_the_jax_residuals(capsys, policy, flash):
    """The products one layer keeps, by size, are the residuals the JAX
    policy saves, plus what the port keeps and JAX does not show: the
    flash forward's lse rows ("flash_lse": JAX on the CPU runs the
    flash reference, not the kernel) and the "mlp_out" product (XLA
    drops a residual that no backward op reads; the port keeps the six
    names of the selective set as they are)."""
    jp, want = _jax_residuals(capsys, policy, flash)
    cfg = torch_cfg(num_layers=2, seq_length=SEQ,
                    max_position_embeddings=SEQ, use_flash_attn=flash)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    lp = pt_tf.layer_slice(tp["layers"], 0)
    rope = precompute_rope(cfg.head_dim, SEQ, cfg.rope_theta,
                           cfg.rope_scaling_factor, "cpu")
    h = torch.tensor(np.random.RandomState(0).randn(2, SEQ, cfg.hidden_size),
                     dtype=torch.float32, requires_grad=True)
    keep, replay = remat.policy_contexts(policy)
    out = checkpoint(
        lambda x: pt_tf.transformer_layer(lp, cfg, x, rope, None, None)[0],
        h, use_reentrant=False, context_fn=lambda: (keep, replay))
    kept = [(names, [x[0] if isinstance(x, tuple) else x for x in items])
            for names, (_, items) in keep.kept]
    got, extra = [], []
    for names, tensors in kept:
        for i, x in enumerate(tensors):
            if policy == "offload":
                assert x.device.type == "cpu"
            (extra if names == ("attn_ctx", "flash_lse") and i == 1
             or names == ("mlp_out",) else got).append(x.numel())
    assert sorted(got) == want, (kept, want)
    b, g, qpk = 2, cfg.num_query_groups, cfg.q_per_kv
    assert sorted(extra) == sorted(
        [b * SEQ * cfg.hidden_size] + ([b * SEQ * g * qpk] if flash else []))
    if policy != "save_dots":
        assert {n for n, _ in kept} <= {(n,) for n in
                                        remat.SELECTIVE_SAVE_NAMES} | {
            ("attn_ctx", "flash_lse")}
    out.sum().backward()
    # the recompute stops once the last saved tensor is packed, which is
    # before the layer's last product runs: "mlp_out" is kept, and only
    # read where a dropout mask drawn after it makes the recompute go on
    assert [n for n, _ in keep.kept] == [("mlp_out",)]


def test_tag_refuses_unknown_names_and_replay_checks_the_order():
    with pytest.raises(ValueError, match="save point"):
        with remat.tag("attn_scores"):
            pass
    keep, replay = remat.policy_contexts("selective")
    x = torch.randn(4, 4)
    with keep:
        with remat.tag("qkv_proj"):
            x @ x
    with replay:
        with remat.tag("mlp_out"):
            with pytest.raises(RuntimeError, match="forward kept"):
                x @ x


# ---------------------------------------------------------------------------
# the Trainer under selective with block recompute
# ---------------------------------------------------------------------------

TRAIN = dict(micro_batch_size=2, global_batch_size=4, lr=1e-3,
             train_iters=3, log_interval=100, eval_interval=0,
             clip_grad=1.0, weight_decay=0.1, adam_beta2=0.95,
             adam_eps=1e-5, lr_warmup_iters=1, lr_decay_style="cosine",
             min_lr=1e-4, seed=11)


def _batches():
    rs = np.random.RandomState(21)
    return [rs.randint(0, 256, (2, 2, SEQ + 1)).astype(np.int32)
            for _ in range(3)]


def _log(trainer, log):
    inner = trainer.train_step

    def step(state, text, *a):
        stats = inner(state, text, *a)
        log.append((float(stats["loss"]), float(stats["grad_norm"])))
        return stats
    trainer.train_step = step


def test_trainer_selective_block_matches_jax_trainer():
    """3 steps of 2 microbatches under remat "selective" on the first 2
    of 3 layers: losses and gradient norms within 1e-5 relative, final
    params within 1e-5."""
    model = dict(num_layers=3, seq_length=SEQ, max_position_embeddings=SEQ,
                 use_flash_attn=True, remat_policy="selective",
                 recompute_method="block", recompute_num_layers=2)
    jm = JaxLlama(jax_cfg(**model))
    jt = JaxTrainer(jm, JaxTrainConfig(**TRAIN),
                    JaxParallelConfig(num_microbatches=2),
                    train_data_iterator=iter(_batches()))
    jstate = jt.setup()
    init = jax.tree.map(np.asarray, jstate.params)
    jlog = []
    _log(jt, jlog)
    jstate = jt.train(jstate)
    tm = LlamaModel(torch_cfg(**model), device="cpu")
    pt = Trainer(tm, TrainConfig(**TRAIN), ParallelConfig(num_microbatches=2),
                 train_data_iterator=iter(_batches()))
    state = pt.setup(params=params_from_jax(init, tm.cfg, device="cpu"))
    log = []
    _log(pt, log)
    state = pt.train(state)
    for (l, g), (rl, rg) in zip(log, jlog, strict=True):
        assert l == pytest.approx(rl, rel=1e-5)
        assert g == pytest.approx(rg, rel=1e-5)
    jflat = _flat(jax.tree.map(np.asarray, jstate.params))
    pflat = _flat(state.params)
    for name, ref in jflat.items():
        close(pflat[name].detach().numpy(), ref, 1e-5, name)

