"""PyTorch port, pipeline parallelism (training) against the JAX package.

The same tiny Llama weights (fp32, 4 layers, h 64, 8 heads in 2 KV
groups, seq 16) and batches (4 microbatches, an uneven loss mask) go
through the JAX package's `make_pipelined_loss_fn`, `jax.grad` of it
and `make_pipelined_train_step` on its virtual CPU mesh, and through the
port's ranks at the same layouts, gloo CPU processes
(utils/virtual_mesh.spawn_cpu_group): pp 2 and pp 4, pp 2 x tp 2 with
and without sequence parallelism, pp 2 x dp 2 with ZeRO-1.

- the loss within rtol 1e-5 / atol 1e-6 of the JAX package's (the mean
  over microbatches of each one's masked mean, JAX :158-161);
- the gathered gradient tree within rtol 1e-4 / atol 1e-5, under every
  `pipeline_remat` policy;
- three Trainer steps (AdamW, clipping, weight decay) within 1e-5 of
  the JAX pipelined step's losses and gradient norms, the final params
  within rtol 1e-4 / atol 1e-5, every stage's copy of the replicated
  leaves (embedding, final norm, head, their moments) equal bit for bit;
- `Trainer.evaluate` at pp 2 within 1e-5 of the JAX pipelined loss;
- checkpoints with the optimizer state across layouts: step 1 saved at
  pp 2, at pp 2 x dp 2 with ZeRO-1 and at pp 1, steps 2 and 3 resumed
  at pp 2, pp 2 x dp 2 with ZeRO-1 and pp 1 give the uninterrupted JAX
  pipelined step's losses, gradient norms and final params (step 3 and
  the params depend on the saved Adam moments and step count); the pp 2
  checkpoint serves with no layout;
- `finetune.main` in two ranks with the recipe's
  `--pipeline_model_parallel_size 2 --pipeline_remat tick` gives the
  world-size-1 run's losses and gradient norms within 1e-5;
- the refusals: num_layers % pp, dropout, --reset_attention_mask and
  async_pipeline_dispatch;
- tools/reshard_checkpoint.py takes --pipeline_model_parallel_size, and
  tools/pipeline_memory_table.py measures every policy's schedule.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_pp_ranks as R
import torch_ranks
from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.config import tiny_config as jax_tiny_config
from megatron_llm_tpu.data import indexed_dataset as jax_idx
from megatron_llm_tpu.models import LlamaModel as JaxLlama
from megatron_llm_tpu.optimizer import init_optimizer_state
from megatron_llm_tpu.parallel.mesh import destroy_parallel as jax_destroy
from megatron_llm_tpu.parallel.mesh import (
    initialize_parallel as jax_initialize,
)
from megatron_llm_tpu.parallel.pipeline import (
    make_pipelined_loss_fn,
    make_pipelined_train_step,
    pipeline_param_specs,
)
from megatron_llm_tpu_torch import arguments
from megatron_llm_tpu_torch.config import ParallelConfig
from megatron_llm_tpu_torch.convert.from_jax import params_from_jax
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.parallel import mesh
from megatron_llm_tpu_torch.training.checkpointing import load_checkpoint
from megatron_llm_tpu_torch.utils.virtual_mesh import spawn_cpu_group

torch.set_num_threads(1)

MICRO, ROWS, SEQ = 4, 2, R.SEQ
POLICIES = ("tick", "full", "selective", "dots", "save_dots", "offload",
            "none")
# (dp, pp, tp, sp) of the 4-rank group's loss cases
LAYOUTS4 = [(1, 4, 1, False), (1, 2, 2, False), (1, 2, 2, True),
            (2, 2, 1, False)]
IDS4 = ["pp4", "pp2-tp2", "pp2-tp2-sp", "pp2-dp2"]
TRAIN2 = [("pp2", 1, 2, 1, False, False, "tick")]
TRAIN4 = [("pp2-dp2-zero1", 2, 2, 1, False, True, "tick"),
          ("pp2-tp2-sp", 1, 2, 2, True, False, "selective")]
FT = ("--model_name llama2 --num_layers 4 --hidden_size 64 "
      "--num_attention_heads 4 --num_attention_heads_kv 2 "
      "--ffn_hidden_size 128 --seq_length 32 --micro_batch_size 1 "
      "--global_batch_size 4 --lr 1e-3 --lr_decay_style cosine "
      "--lr_warmup_iters 1 --tokenizer_type NullTokenizer "
      "--null_vocab_size 255 --split 98,2,0 --eval_interval 2 "
      "--eval_iters 1 --log_interval 1 --recompute_granularity selective "
      "--seed 3 --train_iters 3").split()
FT_PP = ["--pipeline_model_parallel_size", "2", "--pipeline_remat", "tick",
         "--distributed_backend", "gloo"]


def _corpus(prefix, seed, n_docs=400, vocab=255):
    rs = np.random.RandomState(seed)
    b = jax_idx.MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    for _ in range(n_docs):
        b.add_item(np.append(rs.randint(0, vocab, rs.randint(4, 60)), vocab))
        b.end_document()
    b.finalize(prefix + ".idx")
    return prefix


def _jax_cfg():
    return jax_tiny_config(
        num_layers=4, hidden_size=64, num_attention_heads=8,
        num_attention_heads_kv=2, ffn_hidden_size=128, seq_length=SEQ,
        max_position_embeddings=SEQ, padded_vocab_size=256,
        compute_dtype=jnp.float32, params_dtype=jnp.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_close(a, b, rtol=1e-4, atol=1e-5):
    a, b = _flat(a), _flat(b)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k], np.float32),
                                   np.asarray(b[k], np.float32), rtol=rtol,
                                   atol=atol, err_msg=k)


def _on_mesh(dp, pp, tp, sp=False):
    ctx = jax_initialize(dp=dp, pp=pp, tp=tp, sequence_parallel=sp,
                         devices=jax.devices()[:dp * pp * tp])
    return ctx


def _stage_sharded(ctx, cfg, params):
    specs = pipeline_param_specs(cfg, params)
    sh = jax.tree.map(lambda s: NamedSharding(ctx.mesh, s), specs,
                      is_leaf=lambda x: isinstance(x, P))
    return jax.device_put(params, sh)


def _jax_batch(b, masked=True):
    out = {"tokens": jnp.asarray(b["tokens"], jnp.int32),
           "labels": jnp.asarray(b["labels"], jnp.int32)}
    if masked:
        out["loss_mask"] = jnp.asarray(b["loss_mask"])
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rs = np.random.RandomState(0)
    text = rs.randint(0, 256, (MICRO, ROWS, SEQ + 1))
    # an uneven loss mask: the microbatches' denominators differ
    mask = (rs.rand(MICRO, ROWS, SEQ) > 0.35).astype(np.float32)
    mask[1] = 1.0
    batch = {"tokens": text[..., :-1].astype(np.int64),
             "labels": text[..., 1:].astype(np.int64), "loss_mask": mask}
    steps = [rs.randint(0, 256, (MICRO, ROWS, SEQ + 1)).astype(np.int32)
             for _ in range(3)]
    valid = [rs.randint(0, 256, (1, 4, SEQ + 1)).astype(np.int32)
             for _ in range(2)]
    cfg = _jax_cfg()
    model = JaxLlama(cfg)
    params = model.init(jax.random.key(0))
    params_np = jax.tree.map(np.asarray, params)

    jax_out = {}
    for dp, pp, tp, sp, masked in [(1, 2, 1, False, True),
                                   (1, 2, 1, False, False)] + [
            (*lay, True) for lay in LAYOUTS4]:
        ctx = _on_mesh(dp, pp, tp, sp)
        try:
            pcfg = JaxParallelConfig(
                data_parallel_size=dp, pipeline_parallel_size=pp,
                tensor_parallel_size=tp, sequence_parallel=sp,
                num_microbatches=MICRO)
            fn = jax.jit(jax.value_and_grad(
                make_pipelined_loss_fn(model, pcfg, ctx)))
            loss, grads = fn(_stage_sharded(ctx, cfg, params),
                             _jax_batch(batch, masked))
            jax_out[(dp, pp, tp, sp, masked)] = (
                float(loss), jax.tree.map(np.asarray, grads))
        finally:
            jax_destroy()

    # three pipelined train steps and the eval loss at pp 2 x dp 2
    ctx = _on_mesh(2, 2, 1)
    try:
        pcfg = JaxParallelConfig(data_parallel_size=2,
                                 pipeline_parallel_size=2,
                                 num_microbatches=MICRO)
        tcfg = JaxTrainConfig(micro_batch_size=1,
                              global_batch_size=MICRO * ROWS, lr=1e-3,
                              clip_grad=1.0, weight_decay=0.1)
        step = jax.jit(make_pipelined_train_step(model, tcfg, pcfg, ctx))
        p = _stage_sharded(ctx, cfg, params)
        opt = init_optimizer_state(params, tcfg)
        log = []
        for text_i in steps:
            b = {"tokens": jnp.asarray(text_i[..., :-1]),
                 "labels": jnp.asarray(text_i[..., 1:])}
            p, opt, stats = step(p, opt, b, jnp.float32(1e-3),
                                 jnp.float32(0.1))
            log.append({"loss": float(stats["loss"]),
                        "grad_norm": float(stats["grad_norm"])})
        loss_fn = jax.jit(make_pipelined_loss_fn(model, pcfg, ctx))
        evals = [float(loss_fn(p, {
            "tokens": jnp.asarray(v[..., :-1]),
            "labels": jnp.asarray(v[..., 1:])})) for v in valid]
        jax_train = {"log": log, "params": jax.tree.map(np.asarray, p),
                     "eval": float(np.mean(evals))}
    finally:
        jax_destroy()

    ck = str(tmp_path_factory.mktemp("pp_ckpt"))
    ck4 = str(tmp_path_factory.mktemp("pp_dp_ckpt"))
    # a pp 1 checkpoint of step 1, and steps 2 and 3 resumed from it at
    # pp 1
    ck1 = str(tmp_path_factory.mktemp("pp1_ckpt"))
    pp1_log = []
    for iters, save in ((1, ck1), (3, None)):
        tr = _pp1_trainer(params_np, steps[1 if iters > 1 else 0:], iters,
                          ck1, save)
        R._stats_hook(tr, pp1_log)
        tr.train(tr.setup(params=params_from_jax(
            params_np, R.model_cfg(use_flash_attn=True), device="cpu")))
    data = str(tmp_path_factory.mktemp("pp_corpus"))
    ft = FT + ["--data_path", _corpus(os.path.join(data, "A"), 0)]
    ft_init = jax.tree.map(np.asarray, JaxLlama(dataclasses.replace(
        cfg, num_attention_heads=4, seq_length=32,
        max_position_embeddings=32)).init(jax.random.key(1)))
    ft_one = torch_ranks.finetune_runs([ft], ft_init)
    loss_cases2 = [(1, 2, 1, False, r, True) for r in POLICIES] + [
        (1, 2, 1, False, "tick", False)]
    port2 = spawn_cpu_group(2, R.suite, [
        ("loss_and_grads", (loss_cases2, params_np, batch)),
        ("train_runs", (TRAIN2, params_np, steps, valid)),
        ("checkpoint_runs", (params_np, steps, ck, ck1)),
        ("refusals", ()),
        ("finetune_runs", ([ft + FT_PP], ft_init)),
        ("memory_table", ())],
        timeout_s=240)
    loss_cases4 = [(*lay, "tick", True) for lay in LAYOUTS4]
    port4 = spawn_cpu_group(4, R.suite, [
        ("loss_and_grads", (loss_cases4, params_np, batch)),
        ("train_runs", (TRAIN4, params_np, steps, valid)),
        ("checkpoint_runs", (params_np, steps, ck4, ck1, 2, True))],
        timeout_s=240)
    return {"params": params_np, "jax": jax_out, "jax_train": jax_train,
            "port2": port2, "port4": port4, "ck": ck, "steps": steps,
            "ft_one": ft_one, "pp1_log": pp1_log}


def _pp1_trainer(params_np, data, iters, load, save):
    from megatron_llm_tpu_torch.config import TrainConfig
    from megatron_llm_tpu_torch.training.trainer import Trainer

    tcfg = TrainConfig(micro_batch_size=ROWS, global_batch_size=MICRO * ROWS,
                       lr=1e-3, lr_decay_style="constant", train_iters=iters,
                       log_interval=100, eval_interval=0, clip_grad=1.0,
                       weight_decay=0.1, seed=0, load=load, save=save,
                       save_interval=1)
    return Trainer(LlamaModel(R.model_cfg(use_flash_attn=True), device="cpu"),
                   tcfg, ParallelConfig(num_microbatches=MICRO),
                   train_data_iterator=list(data))


@pytest.mark.parametrize("i", range(len(POLICIES)), ids=POLICIES)
def test_pp2_loss_and_grads_match_jax_under_each_policy(results, i):
    want_loss, want_grads = results["jax"][(1, 2, 1, False, True)]
    got = [r[0][i] for r in results["port2"]]
    assert got[0]["loss"] == got[1]["loss"]
    np.testing.assert_allclose(got[0]["loss"], want_loss, rtol=1e-5,
                               atol=1e-6)
    _assert_trees_close(got[0]["grads"], want_grads)


def test_pp2_without_a_loss_mask_matches_jax(results):
    want_loss, want_grads = results["jax"][(1, 2, 1, False, False)]
    got = results["port2"][0][0][len(POLICIES)]
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5, atol=1e-6)
    _assert_trees_close(got["grads"], want_grads)


def test_the_uneven_mask_is_the_mean_of_microbatch_means(results):
    """The pipelined loss is not the global token-weighted mean: the mask
    leaves the microbatches' denominators uneven, and the two forms
    differ here."""
    rs = np.random.RandomState(0)
    rs.randint(0, 256, (MICRO, ROWS, SEQ + 1))
    mask = (rs.rand(MICRO, ROWS, SEQ) > 0.35).astype(np.float32)
    mask[1] = 1.0
    dens = mask.sum(axis=(1, 2))
    assert len(set(dens.tolist())) > 1
    loss = results["port2"][0][0][0]["loss"]
    assert loss == results["jax"][(1, 2, 1, False, True)][0] or np.isclose(
        loss, results["jax"][(1, 2, 1, False, True)][0], rtol=1e-5)


@pytest.mark.parametrize("i", range(len(LAYOUTS4)), ids=IDS4)
def test_four_rank_layouts_match_jax(results, i):
    want_loss, want_grads = results["jax"][(*LAYOUTS4[i], True)]
    got = [r[0][i] for r in results["port4"]]
    assert len({g["loss"] for g in got}) == 1
    np.testing.assert_allclose(got[0]["loss"], want_loss, rtol=1e-5,
                               atol=1e-6)
    _assert_trees_close(got[0]["grads"], want_grads)


def _train(results, name):
    for key in ("port2", "port4"):
        if name in results[key][0][1]:
            return [r[1][name] for r in results[key]]
    raise KeyError(name)


@pytest.mark.parametrize("name", [t[0] for t in TRAIN2 + TRAIN4])
def test_three_trainer_steps_match_the_jax_pipelined_step(results, name):
    ranks = _train(results, name)
    want = results["jax_train"]
    for r in ranks:
        assert r["log"] == ranks[0]["log"]
        assert r["agree"], "a stage's replicated leaves drifted"
    for got, exp in zip(ranks[0]["log"], want["log"]):
        np.testing.assert_allclose(got["loss"], exp["loss"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], exp["grad_norm"],
                                   rtol=1e-5, atol=1e-6)
    _assert_trees_close(ranks[0]["params"], want["params"])


@pytest.mark.parametrize("name", [t[0] for t in TRAIN2 + TRAIN4])
def test_trainer_evaluate_runs_the_pipelined_loss(results, name):
    """After the three steps, against the JAX pipelined loss of the JAX
    step's params."""
    ranks = _train(results, name)
    assert len({r["eval"] for r in ranks}) == 1
    np.testing.assert_allclose(ranks[0]["eval"], results["jax_train"]["eval"],
                               rtol=1e-5, atol=1e-6)


def _assert_resumed(log, params, want):
    """Steps 2 and 3 of a resumed run against the uninterrupted JAX
    pipelined step's, and its final params."""
    assert len(log) == 2
    for got, exp in zip(log, want["log"][1:]):
        np.testing.assert_allclose(got["loss"], exp["loss"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], exp["grad_norm"],
                                   rtol=1e-5, atol=1e-6)
    _assert_trees_close(params, want["params"])


def test_pp2_checkpoint_resumes_at_pp1_and_serves_without_a_layout(results):
    from megatron_llm_tpu_torch.config import TrainConfig
    from megatron_llm_tpu_torch.inference.generation import generate_tokens
    from megatron_llm_tpu_torch.training.trainer import Trainer

    ranks = [r[2] for r in results["port2"]]
    cfg = R.model_cfg(use_flash_attn=True)
    model = LlamaModel(cfg, device="cpu")
    restored = load_checkpoint(results["ck"], model.abstract_params(),
                               no_load_optim=True, device="cpu")
    assert restored is not None and restored[3] == 1
    assert os.path.exists(os.path.join(restored[2]["loaded_path"], "optim"))
    saved = _flat(ranks[0]["saved_params"])
    for k, v in _flat(R._np(restored[0])).items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    # steps 2 and 3 resumed at pp 1, the optimizer state loaded
    tcfg = TrainConfig(micro_batch_size=ROWS, global_batch_size=MICRO * ROWS,
                       lr=1e-3, lr_decay_style="constant", train_iters=3,
                       log_interval=100,
                       eval_interval=0, clip_grad=1.0, weight_decay=0.1,
                       seed=0, load=results["ck"])
    tr = Trainer(model, tcfg, ParallelConfig(num_microbatches=MICRO),
                 train_data_iterator=list(results["steps"][1:]))
    log = []
    R._stats_hook(tr, log)
    state = tr.train(tr.setup(params=params_from_jax(results["params"], cfg,
                                                     device="cpu")))
    assert ranks[0]["resumed"] == ranks[1]["resumed"]
    _assert_resumed(log, R._np(state.params), results["jax_train"])
    # serving with no layout from the pp 2 checkpoint
    toks = np.zeros((1, 12), np.int64)
    toks[0, :4] = [5, 6, 7, 8]
    out = generate_tokens(model, restored[0], toks, np.array([4]),
                          prefill_len=4)
    assert tuple(out.tokens.shape) == (1, 12)


@pytest.mark.parametrize("group,run", [
    ("port2", "resumed"), ("port2", "from_pp1"), ("port4", "resumed"),
    ("port4", "from_pp1")], ids=["pp2-from-pp2", "pp2-from-pp1",
                                 "pp2-dp2-zero1-from-itself",
                                 "pp2-dp2-zero1-from-pp1"])
def test_resumed_steps_match_the_uninterrupted_step(results, group, run):
    """Steps 2 and 3 resumed from a checkpoint of step 1 with its Adam
    moments and step count, at pp 2 and at pp 2 x dp 2 with ZeRO-1."""
    ranks = [r[2] for r in results[group]]
    assert all(r[run] == ranks[0][run] for r in ranks)
    _assert_resumed(ranks[0][run], ranks[0][run + "_params"],
                    results["jax_train"])


def test_refusals(results):
    got = results["port2"][0][3]
    assert "dropout" in got["dropout"] and "item 3" in got["dropout"]
    assert "does not divide num_layers" in got["odd_layers"]
    assert "--reset_attention_mask" in got["reset_attention_mask"]
    with pytest.raises(ValueError, match="overlap schedulers.*item 2"):
        ParallelConfig(pipeline_parallel_size=2,
                       async_pipeline_dispatch=True)
    # pp x cp is a layout now (tests/test_torch_context_parallel.py)
    assert ParallelConfig(pipeline_parallel_size=2,
                          context_parallel_size=2).world_size == 4
    with pytest.raises(RuntimeError, match="needs the default process"):
        mesh.initialize_parallel(pp=2, cp=2, device="cpu")
    args = arguments.build_base_parser().parse_args(
        "--model_name llama2 --num_layers 3 "
        "--pipeline_model_parallel_size 2".split())
    with pytest.raises(ValueError, match="does not divide --num_layers 3"):
        arguments.args_to_configs(args, 256, world_size=2)


def test_the_parser_takes_the_recipes_pp_flags():
    args = arguments.build_base_parser().parse_args(
        "--model_name llama2 --num_layers 4 --micro_batch_size 1 "
        "--global_batch_size 8 --pipeline_model_parallel_size 2 "
        "--tensor_model_parallel_size 2 --pipeline_remat dots".split())
    _, pcfg, _, _ = arguments.args_to_configs(args, 256, world_size=8)
    assert (pcfg.data_parallel_size, pcfg.pipeline_parallel_size,
            pcfg.tensor_parallel_size, pcfg.num_microbatches) == (2, 2, 2, 4)
    assert pcfg.resolved_pipeline_remat == "save_dots"
    assert dataclasses.replace(pcfg, pipeline_remat="tick") \
        .resolved_pipeline_remat == "full"


def test_finetune_at_pp2_matches_world_size_1(results):
    want = results["ft_one"]["runs"][0]["steps"]
    assert [s[0] for s in want] == [1, 2, 3]
    for rank in results["port2"]:
        got = rank[4]
        assert got["jax_modules"] == []
        steps = got["runs"][0]["steps"]
        assert [s[0] for s in steps] == [1, 2, 3]
        for g, w in zip(steps, want):
            assert abs(g[1] - w[1]) <= 1e-5, (g[1], w[1])
            assert abs(g[2] - w[2]) <= 1e-5 * w[2], (g[2], w[2])


def test_memory_table_runs_every_policy(results):
    rows = results["port2"][0][5]
    from megatron_llm_tpu_torch.tools.pipeline_memory_table import (
        MICROBATCHES,
        POLICIES,
    )

    assert [(r["policy"], r["num_micro"]) for r in rows] == [
        (p, n) for p in POLICIES for n in MICROBATCHES]
    for n in MICROBATCHES:
        losses = {r["loss"] for r in rows if r["num_micro"] == n}
        assert len(losses) == 1, losses
    assert all(r["boundary_stash_bytes"] < r["full_stash_1f1b_bytes"]
               for r in rows)


def test_reshard_tool_takes_the_pp_flag(results, tmp_path):
    from megatron_llm_tpu_torch.tools import reshard_checkpoint

    out = reshard_checkpoint.main([
        "--load", results["ck"], "--save", str(tmp_path / "rel"),
        "--model_name", "llama2", "--num_layers", "4",
        "--pipeline_model_parallel_size", "2", "--release"])
    cfg = R.model_cfg(use_flash_attn=True)
    model = LlamaModel(cfg, device="cpu")
    a = load_checkpoint(results["ck"], model.abstract_params(),
                        no_load_optim=True, device="cpu")[0]
    b = load_checkpoint(str(tmp_path / "rel"), model.abstract_params(),
                        no_load_optim=True, device="cpu")[0]
    assert out.endswith("release")
    for k, v in _flat(R._np(a)).items():
        np.testing.assert_array_equal(v, _flat(R._np(b))[k], err_msg=k)


def test_pp1_checkpoint_resumes_at_pp2(results):
    ranks = [r[2] for r in results["port2"]]
    pp1 = results["pp1_log"]
    assert len(pp1) == 3 and all(len(r["from_pp1"]) == 2 for r in ranks)
    for r in ranks:
        for got, want in zip(r["from_pp1"], pp1[1:]):
            np.testing.assert_allclose(got["loss"], want["loss"],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-5)
