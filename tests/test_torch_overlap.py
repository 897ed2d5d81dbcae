"""PyTorch port, the overlap schedulers (optimizer/zero1.py,
training/train_step.py, parallel/pipeline.py; JAX tests/test_overlap.py).

- The plan: `build_overlap_plan` equals the JAX package's on the same
  config and template at dp 2 and 4 and two bucket sizes: groups, layer
  axes, layer shapes and the wire bytes per issue point and per reduce.
- The gates: the same ParallelConfigs raise in both packages.
- Against the JAX package's explicit overlap path at dp 2 on its
  virtual CPU mesh, from the same weights and batches: losses and grad
  norms within 1e-5.
- Numerics, gloo CPU ranks, fp32, a 4-layer model whose layers form two
  groups: at dp 2 `--overlap_grad_reduce` alone, `--overlap_param_gather`
  alone and both, without recompute and under full and selective
  recompute, give the eager ZeRO-1 run's losses, gradient norms, final
  params and moments bit for bit (at dp 2 each sum has two operands);
  each group's reduce-scatter is issued inside the backward; at dp 4
  losses and gradient norms within 1e-6 relative and each leaf of the
  state within 1e-6 in norm; fp16 with the dynamic scaler skips the same
  steps at the same scales, bit for bit; a watchdog spike skip leaves
  params, moments and step untouched and no reduce-scatter in flight;
  `--quantized_grad_reduce` composes (int8 regrouped by layer group, so
  not bitwise: held to the eager quantized run within the int8 bound).
- Async pipeline dispatch: pp 2 with 4 microbatches, its loss and
  gradients bit for bit lockstep's, deterministic and with hidden
  dropout live.
- An async collective that times out raises at its handle's wait().
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_overlap_ranks as R
from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import tiny_config as jax_tiny_config
from megatron_llm_tpu.models import LlamaModel as JaxLlama
from megatron_llm_tpu.optimizer.zero1 import (
    build_overlap_plan as jax_build_overlap_plan,
)
from megatron_llm_tpu_torch.config import ParallelConfig
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.optimizer.zero1 import build_overlap_plan
from megatron_llm_tpu_torch.utils.virtual_mesh import spawn_cpu_group

torch.set_num_threads(1)

# (name, options): dp 2 runs, each a Trainer of 3 steps
DP2 = [("eager", {}), ("grads", dict(grads=True)),
       ("gather", dict(gather=True)), ("both", dict(grads=True, gather=True)),
       ("eager-full", dict(remat="full")),
       ("both-full", dict(grads=True, gather=True, remat="full")),
       ("eager-selective", dict(remat="selective")),
       ("both-selective", dict(grads=True, gather=True, remat="selective")),
       ("eager-quant", dict(quant=True)),
       ("both-quant", dict(grads=True, gather=True, quant=True)),
       ("eager-fp16", dict(fp16=True)),
       ("both-fp16", dict(grads=True, gather=True, fp16=True))]
BITWISE = ["grads", "gather", "both", "both-full", "both-selective"]
# an int8 wire regrouped by layer group moves the chunk boundaries the
# scales are taken over: the losses stay within this of eager int8's
QUANT_TOL = 1e-3


def _jax_cfg(layers):
    return jax_tiny_config(num_layers=layers, hidden_size=64,
                           num_attention_heads=8, num_attention_heads_kv=2,
                           ffn_hidden_size=128, seq_length=R.SEQ,
                           max_position_embeddings=R.SEQ,
                           padded_vocab_size=256, compute_dtype=jnp.float32,
                           params_dtype=jnp.float32)


@pytest.fixture(scope="module")
def runs():
    params, data = R.params_np(), R.batches(3, 2, 4)
    jobs = [("train", (dict(opts, dp=2), params, data)) for _, opts in DP2]
    jobs += [("skip_step", (dict(dp=2, grads=True, gather=True), params,
                            data)),
             ("skip_step", (dict(dp=2), params, data))]
    pipe = R.batches(1, 4, 2, seed=9)[0]
    jobs += [("pipe_loss", (a, params, pipe, rng, remat))
             for rng in (None, 17) for remat in ("tick", "none")
             for a in (False, True)]
    # last: it leaves a group with a failed op behind
    jobs += [("async_timeout", ())]
    two = spawn_cpu_group(2, R.suite, jobs, timeout_s=600)
    four = spawn_cpu_group(4, R.suite, [
        ("train", (dict(dp=4), params, R.batches(3, 2, 8))),
        ("train", (dict(dp=4, grads=True, gather=True, log_memory=True),
                   params, R.batches(3, 2, 8)))], timeout_s=600)
    out = {name: r for (name, _), r in zip(DP2, two[0])}
    n = len(DP2)
    out["skip_overlap"], out["skip_eager"] = two[0][n], two[0][n + 1]
    out["skip_ranks"] = [t[n] for t in two]
    out["pipe"] = two[0][n + 2:-1]
    out["timeout"] = two[0][-1]
    out["dp4"] = four[0]
    out["dp2_ranks"] = [t[:n] for t in two]
    return out


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the plan and the gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("bucket_mb", [0.05, 4.0])
@pytest.mark.parametrize("layers", [4, 5])
def test_plan_equals_jax(dp, bucket_mb, layers):
    jcfg = _jax_cfg(layers)
    jtmpl = jax.eval_shape(JaxLlama(jcfg).init, jax.random.key(0))
    want = jax_build_overlap_plan(jcfg, jtmpl, dp, bucket_mb=bucket_mb)
    tcfg = R.model_cfg(num_layers=layers)
    got = build_overlap_plan(tcfg, LlamaModel(tcfg, device="cpu")
                             .abstract_params(), dp, bucket_mb=bucket_mb)
    assert got.groups == want.groups
    assert got.layer_axes == want.layer_axes
    assert got.layer_shapes == want.layer_shapes
    assert got.aux.leaf_axes == want.aux.leaf_axes
    assert got.aux.buckets == want.aux.buckets
    for q in (False, True):
        assert got.bucket_comm_bytes(q) == want.bucket_comm_bytes(q)
        assert got.comm_bytes_per_reduce(q) == want.comm_bytes_per_reduce(q)
    if bucket_mb < 1:
        assert len(got.groups) > 1
        assert all(hi - lo >= 2 for lo, hi in got.groups)


def test_optimizer_state_specs_follow_the_overlap_layout():
    """Port `optimizer_state_specs(..., overlap_grads=True)` equals the
    JAX package's (tests/test_overlap.py::TestOverlapPlan::
    test_optimizer_state_specs_follow_layout) in both flavors, and the
    trainer's state layout (`overlap_state_plan`) shards each leaf on
    the spec's "data" axis."""
    from jax.sharding import PartitionSpec as P

    from megatron_llm_tpu.parallel.sharding import (
        optimizer_state_specs as jax_specs,
    )
    from megatron_llm_tpu_torch.optimizer.zero1 import overlap_state_plan
    from megatron_llm_tpu_torch.parallel.sharding import (
        optimizer_state_specs,
        spec_leaves,
    )

    jcfg = _jax_cfg(2)
    jtmpl = jax.eval_shape(JaxLlama(jcfg).init, jax.random.key(0))
    tcfg = R.model_cfg(num_layers=2)
    tmpl = LlamaModel(tcfg, device="cpu").abstract_params()
    for over in (False, True):
        want = jax.tree.leaves(jax_specs(jcfg, jtmpl, 2, True,
                                         overlap_grads=over),
                               is_leaf=lambda x: isinstance(x, P))
        got = spec_leaves(optimizer_state_specs(tcfg, tmpl, 2, True,
                                                overlap_grads=over))
        assert [tuple(s) for s in want] == [
            tuple(s) + (None,) * (len(w) - len(s))
            for s, w in zip(got, want)]
    plan = overlap_state_plan(build_overlap_plan(tcfg, tmpl, 2,
                                                 R.BUCKET_MB), tmpl)
    got = spec_leaves(optimizer_state_specs(tcfg, tmpl, 2, True,
                                            overlap_grads=True))
    for k, s in zip(plan.leaf_axes, got):
        assert k == (s.index("data") if "data" in s else None)


GATES = [
    (dict(data_parallel_size=2, overlap_grad_reduce=True),
     "use_distributed_optimizer"),
    (dict(data_parallel_size=2, overlap_param_gather=True),
     "use_distributed_optimizer"),
    (dict(data_parallel_size=2, tensor_parallel_size=2,
          use_distributed_optimizer=True, overlap_param_gather=True),
     "pure-dp"),
    (dict(data_parallel_size=2, pipeline_parallel_size=2,
          use_distributed_optimizer=True, overlap_grad_reduce=True),
     "pure-dp"),
    (dict(data_parallel_size=2, context_parallel_size=2,
          use_distributed_optimizer=True, overlap_grad_reduce=True),
     "pure-dp"),
    (dict(use_distributed_optimizer=True, overlap_grad_reduce=True),
     "data_parallel_size=1"),
    (dict(async_pipeline_dispatch=True), "pipeline_parallel_size"),
    (dict(data_parallel_size=2, use_distributed_optimizer=True,
          overlap_grad_reduce=True, overlap_param_gather=True), None),
    (dict(pipeline_parallel_size=2, async_pipeline_dispatch=True), None),
]


@pytest.mark.parametrize("kw,gate", GATES,
                         ids=[f"gate{i}" for i in range(len(GATES))])
def test_config_gates(kw, gate):
    """JAX tests/test_overlap.py::TestOverlapPlan::test_config_gates: the
    same configs raise in both packages, naming the same gate."""
    if gate is None:
        JaxParallelConfig(**kw)
        pc = ParallelConfig(**kw)
        assert all(getattr(pc, k) == v for k, v in kw.items())
        return
    with pytest.raises(ValueError, match=gate):
        JaxParallelConfig(**kw)
    with pytest.raises(ValueError, match=gate):
        ParallelConfig(**kw)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_overlap():
    """The JAX package's explicit overlap path (both flags) at dp 2 on
    devices 0-1 of its virtual CPU mesh, 3 steps from the port runs'
    weights and global batches: (losses, grad norms)."""
    from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
    from megatron_llm_tpu.parallel.mesh import (
        destroy_parallel,
        initialize_parallel,
    )
    from megatron_llm_tpu.training.trainer import Trainer as JaxTrainer

    params = jax.tree.map(jnp.asarray, R.params_np())
    tcfg = JaxTrainConfig(micro_batch_size=2, global_batch_size=8, lr=1e-3,
                          lr_decay_style="constant", train_iters=3,
                          clip_grad=1.0, weight_decay=0.1, bf16=False)
    pcfg = JaxParallelConfig(data_parallel_size=2, num_microbatches=2,
                             use_distributed_optimizer=True,
                             overlap_grad_reduce=True,
                             overlap_param_gather=True,
                             grad_rs_bucket_mb=R.BUCKET_MB)
    init = JaxLlama.init
    JaxLlama.init = lambda self, rng: params
    initialize_parallel(dp=2, pp=1, tp=1, devices=jax.devices()[:2])
    try:
        trainer = JaxTrainer(JaxLlama(_jax_cfg(R.LAYERS)), tcfg, pcfg)
        state = trainer.setup()
        out = []
        for text in R.batches(3, 2, 4):
            stats = trainer.train_step(state, text)
            out.append((float(stats["loss"]), float(stats["grad_norm"])))
        return out
    finally:
        JaxLlama.init = init
        destroy_parallel()


def test_dp2_overlap_matches_jax(runs, jax_overlap):
    """The port's overlap run (both flags) against the JAX package's
    explicit overlap path on the same weights and batches: losses and
    grad norms within 1e-5 (the JAX path reduces every microbatch, the
    port once a step)."""
    got = [(s["loss"], s["grad_norm"]) for s in runs["both"]["log"]]
    for (lp, gp), (lj, gj) in zip(got, jax_overlap):
        assert abs(lp - lj) <= 1e-5, (got, jax_overlap)
        assert abs(gp - gj) <= 1e-5 * gj, (got, jax_overlap)


@pytest.mark.parametrize("name", BITWISE)
def test_dp2_fp32_bitwise_as_eager(runs, name):
    base = "eager-" + name.split("-")[1] if "-" in name else "eager"
    e, o = runs[base], runs[name]
    assert [s["loss"] for s in o["log"]] == [s["loss"] for s in e["log"]]
    assert [s["grad_norm"] for s in o["log"]] == \
        [s["grad_norm"] for s in e["log"]]
    for key in ("params", "m", "v"):
        _tree_equal(o[key], e[key])
    assert len({s["loss"] for s in e["log"]}) == 3


def test_recompute_changes_no_bit(runs):
    for policy in ("full", "selective"):
        _tree_equal(runs["eager-" + policy]["params"], runs["eager"]["params"])


@pytest.mark.parametrize("name", BITWISE)
def test_every_rank_reports_the_global_loss(runs, name):
    i = [n for n, _ in DP2].index(name)
    logs = [r[i]["log"] for r in runs["dp2_ranks"]]
    assert logs[0] == logs[1]


def test_groups_are_issued_inside_the_backward(runs):
    """Both layer groups' reduce-scatters went out from the last
    microbatch's backward, not after it."""
    for name in ("grads", "both", "both-full", "both-selective"):
        assert runs[name]["groups_in_backward"] == [2], name
    assert runs["gather"]["groups_in_backward"] == [0]


def test_dp4_within_1e6_of_eager(runs):
    e, o = runs["dp4"]
    np.testing.assert_allclose([s["loss"] for s in o["log"]],
                               [s["loss"] for s in e["log"]], rtol=1e-6)
    np.testing.assert_allclose([s["grad_norm"] for s in o["log"]],
                               [s["grad_norm"] for s in e["log"]], rtol=1e-6)
    # four-operand sums in another bucket grouping round apart in last
    # bits, which Adam carries into a few near-zero-gradient elements:
    # each leaf is held in norm
    for key in ("params", "m", "v"):
        for a, b in zip(jax.tree.leaves(o[key]), jax.tree.leaves(e[key])):
            assert np.linalg.norm(a - b) <= 1e-6 * np.linalg.norm(b)


def test_trainer_logs_the_measured_overlap_gauges(runs):
    """Under --log_memory_to_tensorboard with the overlap flags the
    trainer's run facts carry the first step's measured gauges
    (analysis/overlap.py): the groups issued inside the backward with a
    later group still to run (its 2 groups: 1) and the most reductions
    in flight at once; without the flags, none."""
    e, o = runs["dp4"]
    assert o["gauges"]["grad-comm-overlap-pairs"] == 1
    assert o["gauges"]["grad-comm-overlap-max-in-flight"] >= 2
    assert e["gauges"] == {}


def test_fp16_scaler_semantics(runs):
    """The same skip sequence at the same scales, and the same state."""
    e, o = runs["eager-fp16"], runs["both-fp16"]
    assert repr(o["log"]) == repr(e["log"])
    skipped = [s["skipped"] for s in e["log"]]
    assert 0 < sum(skipped) < len(skipped), skipped
    for key in ("params", "m", "v"):
        _tree_equal(o[key], e[key])


def test_spike_skip_leaves_the_state_untouched(runs):
    for name in ("skip_overlap", "skip_eager"):
        got = runs[name]
        assert got["skipped"] == 1
        assert got["params_same"] and got["m_same"] and got["step_same"]
        assert got["in_flight"] == (0, 0)
    assert runs["skip_overlap"]["gathers_after_a_step"] > 0
    assert all(r["skipped"] == 1 and r["params_same"]
               for r in runs["skip_ranks"])


def test_quantized_composes(runs):
    q, e, fp = runs["both-quant"], runs["eager-quant"], runs["eager"]
    lq = [s["loss"] for s in q["log"]]
    assert all(np.isfinite(lq))
    np.testing.assert_allclose(lq, [s["loss"] for s in e["log"]],
                               rtol=QUANT_TOL)
    drift = max(abs(a - b["loss"]) / abs(b["loss"])
                for a, b in zip(lq, fp["log"]))
    assert drift < 0.05  # JAX tests/test_overlap.py's int8 bound
    assert q["groups_in_backward"] == [2]


# ---------------------------------------------------------------------------
# async pipeline dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(4), ids=[
    "deterministic-tick", "deterministic-none", "dropout-tick",
    "dropout-none"])
def test_async_dispatch_bitwise_as_lockstep(runs, case):
    lock, asyn = runs["pipe"][2 * case], runs["pipe"][2 * case + 1]
    assert asyn["loss"] == lock["loss"]
    _tree_equal(asyn["grads"], lock["grads"])
    assert np.isfinite(lock["loss"])


def test_dropout_changes_the_pipelined_loss(runs):
    assert runs["pipe"][4]["loss"] != runs["pipe"][0]["loss"]


def test_a_failed_handle_raises_at_wait(runs):
    """An async collective that times out (a 2 s group, the other rank
    never issues it) raises at its handle's wait(), not swallowed."""
    assert runs["timeout"] is True
