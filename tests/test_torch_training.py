"""PyTorch port, the training slice against the JAX package on the CPU.

Module by module in fp32: `optimizer_step` (AdamW and SGD, clipping, the
skip gate, no decay on 1-D params), the scheduler over a run, the
microbatch calculators, `get_batch` with EOD resets, the chunked head CE
against the direct CE, and `model.loss` with its gradients through the
flash path, with remat "none" and "full" agreeing. Then the slice as a
whole: the port's `Trainer` against the JAX `Trainer` for 3 steps of 2
microbatches with Adam and clipping on the tiny GQA Llama of
tests/torch_parity.py (d 128), and a resume on the port from the JAX
optimizer state after step 2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.config import tiny_config as jax_tiny_config
from megatron_llm_tpu.models import LlamaModel as JaxLlama
from megatron_llm_tpu.models.language_model import (
    chunked_head_cross_entropy as jax_chunked_ce,
)
from megatron_llm_tpu.optimizer.optimizer import (
    OptimizerState as JaxOptState,
    optimizer_step as jax_optimizer_step,
)
from megatron_llm_tpu.optimizer.scheduler import (
    OptimizerParamScheduler as JaxScheduler,
)
from megatron_llm_tpu.parallel.cross_entropy import (
    cross_entropy as jax_cross_entropy,
)
from megatron_llm_tpu.training import microbatches as jax_micro
from megatron_llm_tpu.training.trainer import Trainer as JaxTrainer
from megatron_llm_tpu.training.trainer import get_batch as jax_get_batch
from megatron_llm_tpu_torch.config import ParallelConfig, TrainConfig
from megatron_llm_tpu_torch.config import tiny_config as torch_tiny_config
from megatron_llm_tpu_torch.convert.from_jax import (
    optimizer_state_from_jax,
    params_from_jax,
)
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.models.language_model import (
    chunked_head_cross_entropy,
    lm_logits,
)
from megatron_llm_tpu_torch.optimizer import (
    OptimizerParamScheduler,
    init_optimizer_state,
    optimizer_step,
)
from megatron_llm_tpu_torch.optimizer.optimizer import OptimizerState
from megatron_llm_tpu_torch.parallel.cross_entropy import cross_entropy
from megatron_llm_tpu_torch.training import microbatches
from megatron_llm_tpu_torch.training.trainer import Trainer, get_batch
from torch_parity import close, jax_cfg, t, torch_cfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t_tree(tree):
    """CPU tensors that own copies (the optimizer updates in place)."""
    return jax.tree.map(lambda x: t(np.array(x)), tree)


def _close_tree(port, ref, tol, msg=""):
    if isinstance(ref, dict):
        assert set(port) == set(ref), msg
        for k in ref:
            _close_tree(port[k], ref[k], tol, f"{msg}.{k}")
    else:
        close(port.detach().cpu().numpy(), ref, tol, msg)


# ---------------------------------------------------------------------------
# optimizer, scheduler, microbatches
# ---------------------------------------------------------------------------


def _opt_case(seed):
    rs = np.random.RandomState(seed)
    params = {"w": rs.randn(6, 5).astype(np.float32),
              "layers": {"w1": rs.randn(2, 4, 3).astype(np.float32),
                         "scale": (1 + 0.1 * rs.randn(2, 4)).astype(
                             np.float32)},
              "bias": rs.randn(7).astype(np.float32)}
    grads = jax.tree.map(lambda p: 3 * rs.randn(*p.shape).astype(np.float32),
                         params)
    m = jax.tree.map(lambda p: 0.1 * rs.randn(*p.shape).astype(np.float32),
                     params)
    v = jax.tree.map(lambda p: 0.01 * rs.rand(*p.shape).astype(np.float32),
                     params)
    return params, grads, m, v


@pytest.mark.parametrize("opt", ["adam", "sgd"])
@pytest.mark.parametrize("skip", [False, True], ids=["apply", "skip"])
def test_optimizer_step_matches_jax(opt, skip):
    """One clipped update from a mid-run state (step 3, nonzero moments):
    params, m, v, step, grad norm and the skip flag within 1e-6; 1-D
    leaves are not decayed; a skipped step leaves everything as it was."""
    params, grads, m, v = _opt_case(1)
    kw = dict(optimizer=opt, clip_grad=1.0, weight_decay=0.1,
              adam_beta2=0.95, adam_eps=1e-5)
    jstate = JaxOptState(step=jnp.int32(3), m=m, v=v if opt == "adam" else None)
    jp, js, jst = jax_optimizer_step(
        params, grads, jstate, JaxTrainConfig(**kw), jnp.float32(3e-4),
        weight_decay=jnp.float32(0.1),
        found_inf=jnp.bool_(skip))
    tp = _t_tree(params)
    state = OptimizerState(step=torch.tensor(3, dtype=torch.int32),
                           m=_t_tree(m),
                           v=_t_tree(v) if opt == "adam" else None)
    tp, ts, tst = optimizer_step(
        tp, _t_tree(grads), state, TrainConfig(**kw), 3e-4,
        weight_decay=0.1, found_inf=torch.tensor(skip))
    _close_tree(tp, _np_tree(jp), 1e-6, "params")
    _close_tree(ts.m, _np_tree(js.m), 1e-6, "m")
    if opt == "adam":
        _close_tree(ts.v, _np_tree(js.v), 1e-6, "v")
    assert int(ts.step) == int(js.step) == (3 if skip else 4)
    close(float(tst["grad_norm"]), float(jst["grad_norm"]), 1e-5)
    assert int(tst["skipped"]) == int(jst["skipped"]) == int(skip)
    if skip:
        _close_tree(tp, params, 0, "skipped params")


def test_optimizer_nonfinite_grad_skips_and_no_decay_on_1d():
    params, grads, m, v = _opt_case(2)
    grads["w"][0, 0] = np.nan
    tcfg = TrainConfig(clip_grad=1.0, weight_decay=0.5)
    tp = _t_tree(params)
    state = init_optimizer_state(tp, tcfg)
    _, state, st = optimizer_step(tp, _t_tree(grads), state, tcfg,
                                  1e-2)
    assert int(st["skipped"]) == 1 and int(state.step) == 0
    _close_tree(tp, params, 0, "params after a NaN step")
    # zero grads: only decay moves a leaf, and only one of ndim >= 2 (the
    # JAX rule is by ndim, so stacked (L, h) norm scales are decayed too)
    zeros = jax.tree.map(lambda p: torch.zeros(p.shape), params)
    optimizer_step(tp, zeros, state, tcfg, 1e-2)
    close(tp["bias"].numpy(), params["bias"], 0)
    close(tp["w"].numpy(), params["w"] * (1 - 1e-2 * 0.5), 1e-7)
    close(tp["layers"]["scale"].numpy(),
          params["layers"]["scale"] * (1 - 1e-2 * 0.5), 1e-7)


@pytest.mark.parametrize("lr_style,wd_style", [
    ("linear", "constant"), ("cosine", "linear"),
    ("inverse-square-root", "cosine"), ("constant", "constant")])
def test_scheduler_matches_jax_over_a_run(lr_style, wd_style):
    kw = dict(max_lr=3e-4, min_lr=3e-5, lr_warmup_steps=5,
              lr_decay_steps=40, lr_decay_style=lr_style,
              start_wd=0.1 if wd_style == "constant" else 0.0, end_wd=0.1,
              wd_incr_steps=40, wd_incr_style=wd_style)
    a, b = OptimizerParamScheduler(**kw), JaxScheduler(**kw)
    for step in range(50):
        assert (a.get_lr(), a.get_wd()) == (b.get_lr(), b.get_wd()), step
        a.step(1 + step % 2)
        b.step(1 + step % 2)
    sd = a.state_dict()
    c = OptimizerParamScheduler(**kw)
    c.load_state_dict(sd)
    assert c.get_lr() == a.get_lr()


def test_microbatch_calculators_match_jax():
    for args in [(16, 2, 1, None), (32, 2, 1, (8, 8, 64))]:
        a = microbatches.build_num_microbatches_calculator(*args)
        b = jax_micro.build_num_microbatches_calculator(*args)
        for consumed in range(0, 200, 12):
            a.update(consumed)
            b.update(consumed)
            assert (a.get(), a.get_current_global_batch_size()) == \
                (b.get(), b.get_current_global_batch_size())
        assert microbatches.iterations_for_samples(1000, *args) == \
            jax_micro.iterations_for_samples(1000, *args)


def test_loss_watchdog_matches_jax():
    """The same loss series (a spike, a NaN, a flat stretch) gives the
    same thresholds, verdicts and counters in both copies."""
    from megatron_llm_tpu.training.watchdog import LossWatchdog as JaxDog
    from megatron_llm_tpu_torch.training.watchdog import LossWatchdog

    rs = np.random.RandomState(3)
    series = list(3 + 0.05 * rs.randn(30)) + [9.0, float("nan")] + \
        [2.5] * 12
    a, b = LossWatchdog(k_sigma=4.0, window=16), JaxDog(k_sigma=4.0,
                                                         window=16)
    for x in series:
        assert a.threshold() == b.threshold()
        assert a.observe(x) == b.observe(x)
    assert a.counters() == b.counters() == {
        "loss_watchdog_skipped": 2, "loss_watchdog_rollbacks": 0}


@pytest.mark.parametrize("resets", [(False, False, False), (True, True, True),
                                    (True, False, True)],
                         ids=["plain", "all_resets", "positions_only"])
def test_get_batch_matches_jax(resets):
    rs = np.random.RandomState(4)
    text = rs.randint(0, 6, (2, 3, 13)).astype(np.int32)  # eod = 1 is common
    pos, attn, lossm = resets
    ours = get_batch(text, 1, pos, attn, lossm, device="cpu")
    ref = jax_get_batch(text, 1, pos, attn, lossm)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# cross entropy and the model loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    rs = np.random.RandomState(5)
    logits = 4 * rs.randn(3, 7, 50).astype(np.float32)
    labels = rs.randint(0, 50, (3, 7))
    close(cross_entropy(t(logits), t(labels), smoothing).numpy(),
          jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            smoothing), 1e-5)


def test_chunked_head_ce_matches_direct_and_jax():
    """s 3072 takes the chunked path (three chunks of 1024): losses and
    gradients equal the direct CE's, and the losses the JAX chunked CE's."""
    cfg = torch_tiny_config(compute_dtype=torch.float32)
    rs = np.random.RandomState(6)
    hidden = rs.randn(1, 3072, 64).astype(np.float32)
    head = 0.1 * rs.randn(64, 256).astype(np.float32)
    labels = rs.randint(0, 256, (1, 3072))
    params = {"lm_head": t(head).requires_grad_(True)}
    h = t(hidden).requires_grad_(True)
    got = chunked_head_cross_entropy(params, cfg, h, t(labels))
    got.sum().backward()
    g_h, g_w = h.grad.clone(), params["lm_head"].grad.clone()
    h.grad = None
    params["lm_head"].grad = None
    direct = cross_entropy(lm_logits(params, cfg, h), t(labels))
    direct.sum().backward()
    close(got.detach().numpy(), direct.detach().numpy(), 1e-6)
    close(g_h.numpy(), h.grad.numpy(), 1e-6)
    ref_w = params["lm_head"].grad.numpy()  # a sum over 3072 rows
    close(g_w.numpy(), ref_w, 1e-6 * np.abs(ref_w).max())
    ref = jax_chunked_ce({"lm_head": jnp.asarray(head)},
                         jax_tiny_config(compute_dtype=jnp.float32),
                         jnp.asarray(hidden), jnp.asarray(labels))
    close(got.detach().numpy(), ref, 1e-5)


def _loss_pair(**kw):
    """JAX and port tiny GQA Llamas (fp32) on the same weights."""
    jm = JaxLlama(jax_cfg(**kw))
    jp = jm.init(jax.random.key(3))
    tm = LlamaModel(torch_cfg(**kw), device="cpu")
    return jm, jp, tm, params_from_jax(_np_tree(jp), tm.cfg, device="cpu")


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "grouped"])
def test_model_loss_and_grads_match_jax(flash):
    """The masked mean loss and every parameter's gradient within 1e-5
    (relative to the leaf's largest gradient), with remat "none" and
    "full" on the port agreeing within 1e-6; the flash path runs the
    plain forward and backward of `_Flash` on the CPU."""
    jm, jp, tm, tp = _loss_pair(use_flash_attn=flash, use_fused_rmsnorm=True)
    rs = np.random.RandomState(8)
    tokens = rs.randint(0, 256, (2, 48))
    labels = rs.randint(0, 256, (2, 48))
    mask = (rs.rand(2, 48) > 0.2).astype(np.float32)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(tokens), jnp.asarray(labels),
                          loss_mask=jnp.asarray(mask)))(jp)
    ref_grads = _np_tree(ref_grads)
    results = []
    for policy in ("none", "full"):
        model = LlamaModel(dataclasses.replace(tm.cfg, remat_policy=policy),
                           device="cpu")
        params = jax.tree.map(lambda x: x.clone().requires_grad_(True), tp)
        loss = model.loss(params, t(tokens), t(labels), loss_mask=t(mask))
        loss.backward()
        close(loss.item(), float(ref_loss), 1e-5 * abs(float(ref_loss)))
        grads = jax.tree.map(lambda x: x.grad, params)

        def check(g, r, path=""):
            if isinstance(r, dict):
                for k in r:
                    check(g[k], r[k], f"{path}.{k}")
            else:
                close(g.numpy(), r, 1e-5 * max(np.abs(r).max(), 1e-12), path)
        check(grads, ref_grads)
        results.append((loss.item(), grads))
    assert results[0][0] == pytest.approx(results[1][0], rel=1e-6)
    _close_tree(results[0][1], _np_tree(jax.tree.map(
        lambda x: x.numpy(), results[1][1])), 1e-6, "none vs full")


def test_training_after_serving_in_one_process():
    """The cached RoPE table may first be built by a serving forward under
    inference mode; a training forward with the same shapes must still
    differentiate through it."""
    from megatron_llm_tpu_torch.models.rope import precompute_rope

    cfg = torch_tiny_config(max_position_embeddings=72, use_flash_attn=True)
    model = LlamaModel(cfg, device="cpu")
    params = model.init(seed=1)
    toks = torch.zeros(1, 8, dtype=torch.long)
    precompute_rope.cache_clear()
    with torch.inference_mode():
        model.forward(params, toks)
    for p in (params["lm_head"], params["layers"]["attention"]["wqkv"]):
        p.requires_grad_(True)
    model.loss(params, toks, toks).backward()
    assert params["layers"]["attention"]["wqkv"].grad is not None


def test_remat_policies_of_later_slices_raise():
    """What stays refused: the trainer's telemetry hooks, pipeline
    parallelism, and a data-parallel layout with no ranks to run it.
    Selective remat, dropout and fp16 train; their parity with the JAX
    package is in tests/test_torch_{remat,dropout,grad_scaler}.py, and
    data and tensor parallelism's in tests/test_torch_{zero1,
    tensor_parallel,parallel_finetune}.py."""
    tm = LlamaModel(torch_cfg(remat_policy="selective"), device="cpu")
    with pytest.raises(ValueError, match="telemetry"):
        Trainer(tm, TrainConfig(tensorboard_dir="/nonexistent"),
                ParallelConfig())
    with pytest.raises(ValueError, match="pipeline"):
        ParallelConfig(pipeline_parallel_size=2)
    from megatron_llm_tpu_torch.training.train_step import make_train_step

    with pytest.raises(ValueError, match="parallel context"):
        make_train_step(tm, TrainConfig(), ParallelConfig(
            data_parallel_size=2))


# ---------------------------------------------------------------------------
# the slice as a whole: Trainer against the JAX Trainer
# ---------------------------------------------------------------------------

TRAIN = dict(micro_batch_size=2, global_batch_size=4, lr=1e-3,
             train_iters=3, log_interval=100, eval_interval=0,
             clip_grad=1.0, weight_decay=0.1, adam_beta2=0.95,
             adam_eps=1e-5, lr_warmup_iters=1, lr_decay_style="cosine",
             min_lr=1e-4, seed=11)
MODEL = dict(use_flash_attn=True, use_fused_rmsnorm=True,
             remat_policy="full")


def _batches():
    rs = np.random.RandomState(21)
    return [rs.randint(0, 256, (2, 2, 65)).astype(np.int32)
            for _ in range(3)]


def _record(trainer, log, snapshot_at=None, snaps=None):
    """Wraps trainer.train_step: per step (loss, grad norm) floats, and a
    numpy snapshot of the state after step `snapshot_at`."""
    inner = trainer.train_step

    def step(state, text, *a):
        stats = inner(state, text, *a)
        log.append((float(stats["loss"]), float(stats["grad_norm"])))
        if state.iteration == snapshot_at:
            # host copies now: the next jitted step donates these buffers
            snaps.append((_tree_np(state.params),
                          jax.tree.map(np.array, state.opt_state)))
        return stats
    trainer.train_step = step


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy().copy()
    return np.asarray(tree)


@pytest.fixture(scope="module")
def jax_run():
    jm = JaxLlama(jax_cfg(**MODEL))
    trainer = JaxTrainer(jm, JaxTrainConfig(**TRAIN),
                         JaxParallelConfig(num_microbatches=2),
                         train_data_iterator=iter(_batches()))
    state = trainer.setup()
    init = _np_tree(state.params)
    log, snaps = [], []
    _record(trainer, log, snapshot_at=2, snaps=snaps)
    state = trainer.train(state)
    params2, opt2 = snaps[0]
    return dict(init=init, log=log, params=_np_tree(state.params),
                params2=params2, opt2=opt2)


def test_trainer_matches_jax_trainer(jax_run):
    """3 steps, 2 microbatches, AdamW with clipping, cosine lr with a
    warmup step: per-step losses and gradient norms within 1e-5
    relative, final params within 1e-5 max-abs. Observed: losses within
    8.4e-8 relative, gradient norms within 9.1e-8, params within 1.5e-7
    max-abs."""
    tm = LlamaModel(torch_cfg(**MODEL), device="cpu")
    trainer = Trainer(tm, TrainConfig(**TRAIN),
                      ParallelConfig(num_microbatches=2),
                      train_data_iterator=iter(_batches()))
    state = trainer.setup(params=params_from_jax(jax_run["init"], tm.cfg,
                                                 device="cpu"))
    log = []
    _record(trainer, log)
    state = trainer.train(state)
    assert state.iteration == 3 and state.consumed_train_samples == 12
    assert len(log) == len(jax_run["log"]) == 3
    for (l, g), (rl, rg) in zip(log, jax_run["log"]):
        assert l == pytest.approx(rl, rel=1e-5)
        assert g == pytest.approx(rg, rel=1e-5)
    assert [r["loss"] for r in trainer.step_log] == [l for l, _ in log]
    _close_tree(state.params, jax_run["params"], 1e-5, "params")


def test_trainer_resumes_from_jax_optimizer_state(jax_run):
    """The JAX run's params and optimizer state after step 2, carried over
    by the bridge, then the third step on the port: the third loss and
    the final params equal the JAX run's."""
    tm = LlamaModel(torch_cfg(**MODEL), device="cpu")
    trainer = Trainer(tm, TrainConfig(**TRAIN),
                      ParallelConfig(num_microbatches=2),
                      train_data_iterator=iter(_batches()[2:]))
    state = trainer.setup(params=params_from_jax(jax_run["params2"], tm.cfg,
                                                 device="cpu"))
    state.opt_state = optimizer_state_from_jax(jax_run["opt2"], tm.cfg,
                                               device="cpu")
    assert int(state.opt_state.step) == 2
    state.iteration = 2
    trainer.scheduler.step(2)
    log = []
    _record(trainer, log)
    state = trainer.train(state)
    assert state.iteration == 3
    assert log[0][0] == pytest.approx(jax_run["log"][2][0], rel=1e-5)
    assert log[0][1] == pytest.approx(jax_run["log"][2][1], rel=1e-5)
    _close_tree(state.params, jax_run["params"], 1e-5, "params")


@pytest.mark.parametrize("policy", ["full", "none"])
def test_train_step_runs_each_kernel_path_as_often_as_the_card_count(policy):
    """On the CPU the wrappers run the plain versions exactly where the
    card launches the kernels, so counting them checks the per-step
    launch counts chip_smoke.py expects: with full recompute, per layer
    and microbatch, two flash forwards (forward and recompute) and one
    backward, four norm forwards and two norm backwards, plus the final
    norm's forward and backward; without recompute, half the forwards."""
    from unittest import mock

    from megatron_llm_tpu_torch.ops import flash_attention as fa
    from megatron_llm_tpu_torch.ops import rmsnorm as rms

    L, M = 2, 3
    model = LlamaModel(torch_tiny_config(
        num_layers=L, use_flash_attn=True, use_fused_rmsnorm=True,
        remat_policy=policy), device="cpu")
    trainer = Trainer(model, TrainConfig(micro_batch_size=1,
                                         global_batch_size=M),
                      ParallelConfig(num_microbatches=M))
    state = trainer.setup()
    counts = {}

    def counted(name, fn):
        def wrapper(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        return wrapper

    text = np.random.RandomState(0).randint(0, 256, (M, 1, 17))
    with mock.patch.object(fa, "_xla_reference_with_lse",
                           counted("flash_fwd", fa._xla_reference_with_lse)), \
            mock.patch.object(fa, "_plain_bwd",
                              counted("flash_bwd", fa._plain_bwd)), \
            mock.patch.object(rms, "_plain_fwd",
                              counted("norm_fwd", rms._plain_fwd)), \
            mock.patch.object(rms, "_plain_bwd",
                              counted("norm_bwd", rms._plain_bwd)):
        trainer.train_step(state, text)
    recompute = 2 if policy == "full" else 1
    assert counts == {"flash_fwd": recompute * L * M, "flash_bwd": L * M,
                      "norm_fwd": (2 * L * recompute + 1) * M,
                      "norm_bwd": (2 * L + 1) * M}
