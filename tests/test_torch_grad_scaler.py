"""PyTorch port, fp16 training against the JAX package on the CPU: the
loss scalers (optimizer/grad_scaler.py), the fp16 Trainer and the fp16
flash attention.

- The dynamic scaler's trajectory over a fixed overflow sequence that
  grows the scale, holds it through hysteresis, backs it off to
  `min_loss_scale` and resumes from a state_dict taken midway equals the
  JAX scaler's, step by step; the constant scaler's likewise; the state
  lives in 0-d tensors on the params' device.
- Four fp16 Trainer steps against the JAX Trainer's, from the largest
  power-of-two scale step 1 takes cleanly, doubling after every clean
  step, so that a later step overflows, is skipped and backs the scale
  off: equal scales and skip flags, losses and parameters within fp16's
  tolerance; a skipped step leaves the parameters as they were; the
  checkpoint carries the scaler's state.
- The plain fp16 flash forward and backward (the versions K4-K6 are held
  to on the card) against the JAX Pallas kernels under the interpreter
  in fp16.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.config import tiny_config as jax_tiny_config
from megatron_llm_tpu.models import LlamaModel as JaxLlama
from megatron_llm_tpu.optimizer import grad_scaler as jax_gs
from megatron_llm_tpu.training.trainer import Trainer as JaxTrainer
from megatron_llm_tpu_torch.config import ParallelConfig, TrainConfig
from megatron_llm_tpu_torch.config import tiny_config as torch_tiny_config
from megatron_llm_tpu_torch.convert.from_jax import (
    optimizer_state_from_jax,
    params_from_jax,
)
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.ops import flash_attention as fa
from megatron_llm_tpu_torch.optimizer import grad_scaler as gs
from megatron_llm_tpu_torch.optimizer.optimizer import (
    get_grad_scaler,
    tree_leaves,
)
from megatron_llm_tpu_torch.training import checkpointing as ckpt
from megatron_llm_tpu_torch.training.trainer import Trainer
from torch_parity import TINY, close, t

jfa = importlib.import_module("megatron_llm_tpu.ops.flash_attention")

# found_inf per step: 3 clean steps grow the scale (window 3); one
# overflow is absorbed by hysteresis 2, the next backs off; overflows in
# a row back it off to the floor and keep it there
FOUND_INF = [0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 1, 0, 0]


def _jax_traj(scaler, state, seq):
    out = []
    for f in seq:
        out.append(float(scaler.scale(state)))
        state = scaler.update(state, jnp.asarray(bool(f)))
    return out, state


def _port_traj(scaler, state, seq):
    out = []
    for f in seq:
        out.append(float(scaler.scale(state)))
        state = scaler.update(state, torch.tensor(bool(f)))
    return out, state


def test_dynamic_scaler_trajectory_equals_jax():
    kw = dict(initial_scale=2.0 ** 10, min_scale=2.0 ** 6,
              growth_interval=3, hysteresis=2)
    js, ps = jax_gs.DynamicGradScaler(**kw), gs.DynamicGradScaler(**kw)
    jstate, pstate = js.init_state(), ps.init_state("cpu")
    assert all(v.dim() == 0 and v.device.type == "cpu"
               for v in pstate.values())
    half = len(FOUND_INF) // 2
    jt, jstate = _jax_traj(js, jstate, FOUND_INF[:half])
    pt, pstate = _port_traj(ps, pstate, FOUND_INF[:half])
    sd = ps.state_dict(pstate)
    assert sd == js.state_dict(jstate)
    assert set(sd) == {"scale", "growth_tracker", "hysteresis_tracker"}
    # resumed on a fresh scaler from the state_dict
    fresh = gs.DynamicGradScaler(**kw)
    pstate = fresh.load_state_dict(fresh.init_state("cpu"), sd)
    jstate = js.load_state_dict(jstate, js.state_dict(jstate))
    jt2, jstate = _jax_traj(js, jstate, FOUND_INF[half:])
    pt2, pstate = _port_traj(fresh, pstate, FOUND_INF[half:])
    assert pt + pt2 == jt + jt2
    assert fresh.state_dict(pstate) == js.state_dict(jstate)
    scales = pt + pt2
    assert max(scales) == 2.0 ** 11 and min(scales) == 2.0 ** 6
    assert scales.count(2.0 ** 6) >= 3  # held at the floor


def test_constant_scaler_equals_jax():
    js, ps = jax_gs.ConstantGradScaler(1024.0), gs.ConstantGradScaler(1024.0)
    jt, _ = _jax_traj(js, js.init_state(), FOUND_INF[:5])
    pt, state = _port_traj(ps, ps.init_state("cpu"), FOUND_INF[:5])
    assert pt == jt == [1024.0] * 5 and state == {}
    assert ps.state_dict(state) == js.state_dict({})
    ps.load_state_dict(state, {"scale": 512.0})
    assert ps.scale(state) == 512.0


@pytest.mark.parametrize("fp16,loss_scale,kind", [
    (False, None, None), (True, None, gs.DynamicGradScaler),
    (True, 256.0, gs.ConstantGradScaler)])
def test_get_grad_scaler_follows_the_config(fp16, loss_scale, kind):
    tcfg = TrainConfig(fp16=fp16, bf16=not fp16, loss_scale=loss_scale,
                       initial_loss_scale=2.0 ** 8, loss_scale_window=7,
                       hysteresis=3)
    sc = get_grad_scaler(tcfg)
    if kind is None:
        assert sc is None
        return
    assert type(sc) is kind
    if kind is gs.DynamicGradScaler:
        assert (sc.initial_scale, sc.growth_interval, sc.hysteresis) == (
            2.0 ** 8, 7, 3)


# ---------------------------------------------------------------------------
# three fp16 Trainer steps against the JAX Trainer
# ---------------------------------------------------------------------------

SEQ = 16
MODEL = dict(TINY, num_layers=2, seq_length=SEQ, max_position_embeddings=SEQ,
             use_flash_attn=True, remat_policy="full")
# fp16 on both sides: XLA's CPU and torch's CPU fp16 matmuls round
# differently, so losses agree to fp16's precision, not fp32's
FP16_LOSS_TOL = 2e-3


def _batches():
    rs = np.random.RandomState(4)
    return [rs.randint(0, 256, (2, 2, SEQ + 1)).astype(np.int32)] * 4


def _clean_power(tm, tp):
    """The largest power-of-two scale at which one fp16 backward of the
    first batch stays finite: at twice it, it overflows."""
    text = torch.from_numpy(_batches()[0][0]).long()
    leaves = tree_leaves(tp)
    for k in range(8, 40):
        loss = tm.loss(tp, text[:, :-1], text[:, 1:]) * 2.0 ** (k + 1)
        grads = torch.autograd.grad(loss, leaves)
        if not all(torch.isfinite(g).all() for g in grads):
            return k
    raise AssertionError("no scale overflowed")


def _log(trainer, log):
    inner = trainer.train_step

    def step(state, text, *a):
        stats = inner(state, text, *a)
        log.append((float(stats["loss"]), float(stats["loss_scale"]),
                    int(stats["skipped"])))
        return stats
    trainer.train_step = step


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_fp16_trainer_matches_jax_trainer_through_an_overflow(tmp_path):
    jm = JaxLlama(jax_tiny_config(**MODEL, compute_dtype=jnp.float16))
    tm = LlamaModel(torch_tiny_config(**MODEL, compute_dtype=torch.float16),
                    device="cpu")
    jp = jm.init(jax.random.key(2))
    init = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(init, tm.cfg, device="cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    k = _clean_power(tm, tp)
    train = dict(micro_batch_size=2, global_batch_size=4, lr=1e-3,
                 train_iters=4, log_interval=1, eval_interval=0,
                 clip_grad=1.0, seed=3, fp16=True, bf16=False,
                 initial_loss_scale=2.0 ** k, loss_scale_window=1,
                 hysteresis=1)
    jt = JaxTrainer(jm, JaxTrainConfig(**train),
                    JaxParallelConfig(num_microbatches=2),
                    train_data_iterator=iter(_batches()))
    jstate = jt.setup()
    jstate.params = jp
    jlog = []
    _log(jt, jlog)
    jstate = jt.train(jstate)

    pt = Trainer(tm, TrainConfig(**train, save=str(tmp_path)),
                 ParallelConfig(num_microbatches=2),
                 train_data_iterator=iter(_batches()))
    state = pt.setup(params=params_from_jax(init, tm.cfg, device="cpu"))
    log, after = [], {0: {n: v.detach().clone()
                          for n, v in _flat(state.params).items()}}
    _log(pt, log)
    inner = pt.train_step

    def snap(st, text, *a):
        stats = inner(st, text, *a)
        after[st.iteration] = {n: v.detach().clone()
                               for n, v in _flat(st.params).items()}
        return stats
    pt.train_step = snap
    state = pt.train(state)
    pt._save(state, blocking=True)

    # the scale doubles after each clean step until one overflows, which
    # is skipped and halves it (hysteresis 1)
    assert [(s, sk) for _, s, sk in jlog] == [(s, sk) for _, s, sk in log]
    assert log[0][1:] == (2.0 ** k, 0)
    bad = [i for i, (_, _, sk) in enumerate(log) if sk]
    assert bad and bad[0] < 3, log
    assert log[bad[0] + 1][1] == log[bad[0]][1] / 2
    for (l, _, _), (rl, _, _) in zip(log, jlog, strict=True):
        assert l == pytest.approx(rl, rel=FP16_LOSS_TOL)
    for i in bad:  # a skipped step changed nothing
        for name, v in after[i].items():
            assert torch.equal(v, after[i + 1][name]), name
    # Adam moves a parameter by about lr a step whatever its gradient's
    # size, and fp16 rounding can flip the sign of a near-zero gradient:
    # a parameter may differ by 2 lr per clean step
    n_clean = len(log) - len(bad)
    jflat = _flat(jax.tree.map(np.asarray, jstate.params))
    for name, ref in jflat.items():
        got = _flat(state.params)[name].detach().numpy()
        close(got, ref, 2 * train["lr"] * n_clean, name)
        # and the typical parameter agrees to fp16's rounding
        assert np.mean(np.abs(got - ref)) < 1e-4, name
    sc = state.opt_state.scaler
    # the JAX state, carried over by the bridge, is the port's
    bridged = optimizer_state_from_jax(
        jax.tree.map(np.asarray, jstate.opt_state), tm.cfg, device="cpu")
    assert bridged.scaler.keys() == sc.keys()
    for key in sc:
        assert bridged.scaler[key].dtype == sc[key].dtype
        assert torch.equal(bridged.scaler[key], sc[key]), key
    # the checkpoint holds the scaler state under its JAX keys
    optim = torch.load(tmp_path / "iter_0000004" / "optim",
                       weights_only=True)
    assert {k for k in optim if k.startswith("scaler.")} == {
        "scaler.scale", "scaler.growth_tracker", "scaler.hysteresis_tracker"}
    assert float(optim["scaler.scale"]) == float(sc["scale"])
    loaded = ckpt.load_checkpoint(str(tmp_path), state.params,
                                  state.opt_state, tm.cfg)
    assert loaded[1].scaler.keys() == sc.keys()
    for key in sc:
        assert torch.equal(loaded[1].scaler[key], sc[key])


# ---------------------------------------------------------------------------
# the fp16 flash attention's plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

# p and ds round to fp16 on both sides, the kernel after its online
# softmax's running max, the plain version after the full softmax: an
# fp16 ulp or so apart (9.8e-4 at 1)
FLASH_FP16_TOL = 5e-3


@pytest.mark.parametrize("g,qpk,causal", [(2, 2, True), (1, 4, False)],
                         ids=["gqa_causal", "mqa_full"])
def test_fp16_flash_plain_matches_jax_pallas_kernels(g, qpk, causal):
    rs = np.random.RandomState(g + qpk)
    s, d = 128, 128
    q = rs.randn(1, s, g, qpk, d).astype(np.float16)
    k = rs.randn(1, s, g, d).astype(np.float16)
    v = rs.randn(1, s, g, d).astype(np.float16)
    do = rs.randn(1, s, g, qpk, d).astype(np.float16)

    def jfn(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, use_pallas=True,
                                   interpret=True, block_q=32, block_k=32)
    out, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    qt, kt, vt = (t(x).requires_grad_(True) for x in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, causal)
    o.backward(t(do))
    assert o.dtype == torch.float16 and qt.grad.dtype == torch.float16
    ref = np.asarray(out, np.float32)
    close(o.detach().float().numpy(), ref,
          FLASH_FP16_TOL * max(1.0, np.abs(ref).max()), "o")
    for name, got, want in zip("qkv", (qt.grad, kt.grad, vt.grad), jgrads):
        want = np.asarray(want, np.float32)
        close(got.float().numpy(), want,
              FLASH_FP16_TOL * np.abs(want).max(), f"d{name}")
