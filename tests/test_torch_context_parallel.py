"""PyTorch port, context parallelism (cp > 1) against the JAX package at
the same layouts.

The tiny fp32 Llama of the JAX package's cp tests
(tests/test_context_parallel.py:36-50: 2 layers, h 64, 8 heads in 2 KV
groups, seq 64) and batches made from a numpy seed go through the JAX
package on its virtual CPU mesh and through the port's gloo CPU ranks
(utils/virtual_mesh.spawn_cpu_group), the weights carried across by
`convert/from_jax.params_from_jax`:

- the loss and every gradient at cp 2, tp 2 x cp 2 with sequence
  parallelism, dp 2 x cp 2, dp 2 x tp 2 x cp 2 with sequence
  parallelism (the JAX file's 8-device layout, run once) and pp 2 x cp 2
  (the pipelined loss, 4 layers), with a loss mask whose token counts differ between the
  shards: loss within 1e-5 relative, gradients within the JAX file's
  rtol 1e-4 / atol 1e-5;
- packed documents (--reset_attention_mask --reset_position_ids
  --eod_mask_loss, documents straddling the shard boundary) at cp 2;
- three Trainer steps with --eod_mask_loss at cp 2 and at dp 2 x cp 2
  with ZeRO-1 against the JAX Trainer at cp 2 (losses and gradient
  norms within 1e-5, params within rtol 1e-4 / atol 1e-5), and
  `Trainer.evaluate` after them;
- checkpoints with the optimizer state: step 1 saved at cp 2 and
  resumed at cp 2 and at world size 1, and saved at world size 1 and
  resumed at cp 2, each giving the uninterrupted run's steps 2 and 3
  and final params;
- the API at cp 2 (and at pp 2 x cp 2) scores through the ring, padded
  to a multiple of cp, as the JAX package scores at the same layout (and
  as the one-rank scorer does), and generates as the JAX package does at
  cp 2 (and the one-rank route);
- `finetune` under `torch.distributed.run --nproc_per_node 2` with the
  recipe's `--context_parallel_size 2` gives the world-size-1 run's
  losses;
- under each recompute policy the ring's hop forwards run once a
  visible hop, twice under "full", and its hop backwards once;
- the refusals: a dense mask and live attention dropout under cp, cp
  with the BERT/T5 families, and a cp that does not divide the sequence.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_cp_ranks as C
import torch_pp_ranks as R
import torch_ranks
from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.config import tiny_config as jax_tiny_config
from megatron_llm_tpu.data import indexed_dataset as jax_idx
from megatron_llm_tpu.models import LlamaModel as JaxLlama
from megatron_llm_tpu.parallel.mesh import destroy_parallel as jax_destroy
from megatron_llm_tpu.parallel.mesh import (
    initialize_parallel as jax_initialize,
)
from megatron_llm_tpu.parallel.pipeline import (
    make_pipelined_loss_fn,
    pipeline_param_specs,
)
from megatron_llm_tpu.parallel.sharding import param_shardings
from megatron_llm_tpu.training.trainer import Trainer as JaxTrainer
from megatron_llm_tpu.training.trainer import get_batch as jax_get_batch
from megatron_llm_tpu_torch import arguments
from megatron_llm_tpu_torch.config import ParallelConfig
from megatron_llm_tpu_torch.convert.from_jax import params_from_jax
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.utils.virtual_mesh import spawn_cpu_group

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEQ, EOD = C.SEQ, 7
# (name, dp, tp, cp, sp, batch key) of the model cases
MODEL2 = [("cp2", 1, 1, 2, False, "masked"),
          ("cp2-packed", 1, 1, 2, False, "packed")]
MODEL4 = [("tp2-cp2-sp", 1, 2, 2, True, "masked"),
          ("dp2-cp2", 2, 1, 2, False, "masked")]
MODEL8 = [("dp2-tp2-cp2-sp", 2, 2, 2, True, "masked")]
TRAIN2 = [("cp2", 1, 2, False)]
TRAIN4 = [("dp2-cp2-zero1", 2, 2, True)]
# the index of the "scores" job in each spawn's suite
SCORES = {"port2": 4, "port4": 3}
FT = ("--model_name llama2 --num_layers 2 --hidden_size 64 "
      "--num_attention_heads 4 --num_attention_heads_kv 2 "
      "--ffn_hidden_size 128 --seq_length 32 --micro_batch_size 1 "
      "--global_batch_size 2 --lr 1e-3 --lr_decay_style cosine "
      "--lr_warmup_iters 1 --tokenizer_type NullTokenizer "
      "--null_vocab_size 255 --split 98,2,0 --eval_interval 2 "
      "--eval_iters 1 --log_interval 1 --recompute_granularity selective "
      "--eod_mask_loss --seed 3 --train_iters 3").split()
FT_CP = ["--context_parallel_size", "2", "--distributed_backend", "gloo"]


def _jax_cfg(**kw):
    base = dict(num_layers=2, hidden_size=64, num_attention_heads=8,
                num_attention_heads_kv=2, ffn_hidden_size=128,
                seq_length=SEQ, max_position_embeddings=SEQ,
                padded_vocab_size=256, compute_dtype=jnp.float32,
                params_dtype=jnp.float32)
    base.update(kw)
    return jax_tiny_config(**base)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _assert_trees_close(a, b, rtol=1e-4, atol=1e-5):
    a, b = _flat(a), _flat(b)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _text(rs, shape, eods):
    """Tokens in [8, 256) with eod tokens at `eods` of every row's
    sequence: the loss mask of --eod_mask_loss keeps more tokens in the
    second half than in the first."""
    text = rs.randint(8, 256, shape).astype(np.int32)
    text[..., list(eods)] = EOD
    return text


def _data(rs):
    """The model cases' (b, s) batches: "masked", with a loss mask whose
    shards' counts differ, and "packed", documents straddling the shard
    boundary (tests/test_context_parallel.py:254-268)."""
    text = rs.randint(0, 256, (4, SEQ + 1))
    mask = np.ones((4, SEQ), np.float32)
    mask[:, :SEQ // 2] = rs.rand(4, SEQ // 2) > 0.6
    masked = {"tokens": text[:, :-1], "labels": text[:, 1:],
              "loss_mask": mask}
    tokens = rs.randint(8, 256, (2, SEQ))
    tokens[0, SEQ // 3] = EOD
    tokens[1, 10] = EOD
    packed_text = np.concatenate([tokens, rs.randint(8, 256, (2, 1))],
                                 axis=1).astype(np.int32)[None]
    pb = jax_get_batch(packed_text, EOD, True, True, True,
                       packed_doc_starts=True)
    packed = {"tokens": np.asarray(pb["tokens"][0]),
              "labels": np.asarray(pb["labels"][0]),
              "loss_mask": np.asarray(pb["loss_mask"][0]),
              "position_ids": np.asarray(pb["position_ids"][0]),
              "doc_start": np.asarray(pb["attention_mask"]["doc_start"][0])}
    return {"masked": {k: v.astype(np.int64) if k != "loss_mask" else v
                       for k, v in masked.items()},
            "packed": {k: v.astype(np.int64) if k not in (
                "loss_mask", "doc_start") else v for k, v in packed.items()}}


def _jax_model_loss(model, cfg, params, batch, dp, tp, cp, sp):
    ctx = jax_initialize(dp=dp, tp=tp, cp=cp, sequence_parallel=sp,
                         devices=jax.devices()[:dp * tp * cp])
    try:
        sharded = jax.device_put(params, param_shardings(ctx, cfg, params))
        kw = {"loss_mask": jnp.asarray(batch["loss_mask"])}
        if "position_ids" in batch:
            kw["position_ids"] = jnp.asarray(batch["position_ids"])
        if "doc_start" in batch:
            kw["attention_mask"] = {"doc_start": jnp.asarray(
                batch["doc_start"], jnp.int32)}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: model.loss(p, jnp.asarray(batch["tokens"], jnp.int32),
                                 jnp.asarray(batch["labels"], jnp.int32),
                                 **kw)))(sharded)
        return float(loss), jax.tree.map(np.asarray, grads)
    finally:
        jax_destroy()


def _jax_pipelined(model, cfg, params, batch):
    ctx = jax_initialize(pp=2, cp=2, devices=jax.devices()[:4])
    try:
        pcfg = JaxParallelConfig(pipeline_parallel_size=2,
                                 context_parallel_size=2,
                                 num_microbatches=batch["tokens"].shape[0])
        specs = pipeline_param_specs(cfg, params)
        sh = jax.tree.map(lambda s: NamedSharding(ctx.mesh, s), specs,
                          is_leaf=lambda x: isinstance(x, P))
        loss, grads = jax.jit(jax.value_and_grad(make_pipelined_loss_fn(
            model, pcfg, ctx)))(jax.device_put(params, sh), {
                k: jnp.asarray(v) for k, v in batch.items()})
        return float(loss), jax.tree.map(np.asarray, grads)
    finally:
        jax_destroy()


def _jax_api(model, cfg, params, prompts):
    """The JAX package's API on its virtual mesh, from the port's
    requests: at pp 2 x cp 2 `generate_and_post_process` scores (its
    pipelined scorer pads to a multiple of cp and cuts the pad's log-probs,
    api.py:266-280); at cp 2 it generates greedily, and scores through
    `score_tokens` on the request's tokens padded to a multiple of cp the
    same way (its pp 1 scorer takes no length that cp does not divide:
    63 positions here)."""
    from megatron_llm_tpu.inference import api as jax_api
    from megatron_llm_tpu.inference.generation import score_tokens
    from megatron_llm_tpu.inference.tokenization import tokenize_prompts

    tok = C.NumberTokenizer()
    out = {}
    ctx = jax_initialize(cp=2, devices=jax.devices()[:2])
    try:
        sh = jax.device_put(params, param_shardings(ctx, cfg, params))
        tokens, _ = tokenize_prompts(tok, prompts, 0)
        s = tokens.shape[1]
        pad = (-(s - 1)) % ctx.cp
        out["cp2"] = {
            "score": np.asarray(score_tokens(model, sh, jnp.pad(
                jnp.asarray(tokens), ((0, 0), (0, pad)))))[:, :s - 1],
            "greedy": np.asarray(jax_api.generate_and_post_process(
                model, sh, tok, prompts[:1], tokens_to_generate=4,
                top_k_sampling=1)[3])}
    finally:
        jax_destroy()
    ctx = jax_initialize(pp=2, cp=2, devices=jax.devices()[:4])
    try:
        specs = pipeline_param_specs(cfg, params)
        sh = jax.device_put(params, jax.tree.map(
            lambda s: NamedSharding(ctx.mesh, s), specs,
            is_leaf=lambda x: isinstance(x, P)))
        out["pp2-cp2"] = {"score": np.asarray(
            jax_api.generate_and_post_process(model, sh, tok, prompts,
                                              tokens_to_generate=0)[2])}
    finally:
        jax_destroy()
    return out


def _jax_trainer(model, steps, valid):
    """Three JAX Trainer steps at cp 2 with --eod_mask_loss (seed 0, the
    params of model.init(key(0))), then the eval loss of `valid`."""
    ctx = jax_initialize(cp=2, devices=jax.devices()[:2])
    try:
        micro, rows = steps[0].shape[:2]
        tcfg = JaxTrainConfig(micro_batch_size=rows,
                              global_batch_size=micro * rows, lr=1e-3,
                              lr_decay_style="constant", clip_grad=1.0,
                              weight_decay=0.1, seed=0, train_iters=3,
                              log_interval=100, eval_interval=0)
        tr = JaxTrainer(model, tcfg, JaxParallelConfig(
            context_parallel_size=2, num_microbatches=micro),
            eod_token=EOD, eod_mask_loss=True)
        state = tr.setup()
        log = []
        for text in steps:
            stats = tr.train_step(state, text)
            log.append({"loss": float(stats["loss"]),
                        "grad_norm": float(stats["grad_norm"])})
        params = jax.tree.map(np.asarray, state.params)
    finally:
        jax_destroy()
    v = valid[0]
    ev = float(jax.jit(model.loss)(
        params, jnp.asarray(v[..., :-1].reshape(-1, SEQ)),
        jnp.asarray(v[..., 1:].reshape(-1, SEQ))))
    return {"log": log, "params": params, "eval": ev}


def _corpus(prefix, seed, n_docs=300, vocab=255):
    rs = np.random.RandomState(seed)
    b = jax_idx.MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    for _ in range(n_docs):
        b.add_item(np.append(rs.randint(0, vocab, rs.randint(4, 40)), vocab))
        b.end_document()
    b.finalize(prefix + ".idx")
    return prefix


def _torchrun(tmp, argvs, init, nproc=2):
    """`torch_ranks.finetune_runs(argvs, init)` in `nproc` ranks under
    torchrun, each rank's result."""
    d = str(tmp)
    with open(os.path.join(d, "spec.pkl"), "wb") as f:
        pickle.dump({"argvs": argvs, "init": init}, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([REPO, os.path.join(REPO, "tests")])
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc),
         os.path.join(REPO, "tests", "torch_cp_ranks.py"), d], cwd=d,
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    ranks = []
    for r in range(nproc):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rs = np.random.RandomState(0)
    data = _data(rs)
    cfg = _jax_cfg()
    model = JaxLlama(cfg)
    params = model.init(jax.random.key(0))
    params_np = jax.tree.map(np.asarray, params)
    jax_out = {}
    for name, dp, tp, cp, sp, key in MODEL2 + MODEL4 + MODEL8:
        jax_out[name] = _jax_model_loss(model, cfg, params, data[key], dp,
                                        tp, cp, sp)
    cfg4 = _jax_cfg(num_layers=4)
    model4 = JaxLlama(cfg4)
    params4 = jax.tree.map(np.asarray, model4.init(jax.random.key(3)))
    ptext = rs.randint(0, 256, (4, 2, SEQ + 1))
    pmask = np.ones((4, 2, SEQ), np.float32)
    pmask[..., SEQ // 2:] = rs.rand(4, 2, SEQ // 2) > 0.5
    pbatch = {"tokens": ptext[..., :-1].astype(np.int32),
              "labels": ptext[..., 1:].astype(np.int32), "loss_mask": pmask}
    jax_out["pp2-cp2"] = _jax_pipelined(model4, cfg4, params4, pbatch)

    eods = (3, 9, 17, 20, 28, 40)
    steps = [_text(rs, (2, 2, SEQ + 1), eods) for _ in range(3)]
    valid = [_text(rs, (1, 4, SEQ + 1), eods)]
    jax_train = _jax_trainer(model, steps, valid)

    # step 1 saved at world size 1, and the cp 2 checkpoint's resume there
    ck = str(tmp_path_factory.mktemp("cp_ckpt"))
    ck1 = str(tmp_path_factory.mktemp("cp1_ckpt"))
    tr = C.trainer(C.model_cfg(), 1, 1, False, steps[:1], 1, EOD,
                   load=ck1, save=ck1)
    one = {"saved": []}
    R._stats_hook(tr, one["saved"])
    tr.train(tr.setup(params=params_from_jax(params_np, C.model_cfg(),
                                             device="cpu")))

    serve_params = jax.tree.map(np.asarray, model4.init(jax.random.key(5)))
    stoks = rs.randint(1, 256, (3, 21))
    prompts = [" ".join(str(int(t)) for t in row) for row in stoks]
    jax_out["api"] = _jax_api(model4, cfg4, serve_params, prompts)
    port2 = spawn_cpu_group(2, C.suite, [
        ("model_loss_and_grads", ([c[1:] for c in MODEL2], params_np,
                                  data)),
        ("train_runs", (TRAIN2, params_np, steps, valid, EOD, ck)),
        ("resume_from", (params_np, steps, EOD, ck1)),
        ("refusals", ()),
        ("scores", (serve_params, stoks, 1)),
        ("remat_counts", (rs.randint(0, 256, (1, SEQ + 1)),))],
        timeout_s=300)
    port4 = spawn_cpu_group(4, C.suite, [
        ("model_loss_and_grads", ([c[1:] for c in MODEL4], params_np,
                                  data)),
        ("pipelined_loss_and_grads", ([(1, 2, 1, 2, False, "tick")],
                                      params4, pbatch)),
        ("train_runs", (TRAIN4, params_np, steps, valid, EOD,
                        str(tmp_path_factory.mktemp("unused")))),
        ("scores", (serve_params, stoks, 2))], timeout_s=300)
    port8 = spawn_cpu_group(8, C.suite, [
        ("model_loss_and_grads", ([c[1:] for c in MODEL8], params_np,
                                  data))], timeout_s=300)

    # the cp 2 checkpoint's steps 2 and 3 at world size 1
    tr = C.trainer(C.model_cfg(), 1, 1, False, steps[1:], 3, EOD, load=ck)
    log = []
    R._stats_hook(tr, log)
    state = tr.train(tr.setup(params=params_from_jax(
        params_np, C.model_cfg(), device="cpu")))
    one["from_cp2"] = {"log": log, "params": R._np(state.params)}

    # the one-rank API on the same requests
    from megatron_llm_tpu_torch.inference import api

    smodel = LlamaModel(C.model_cfg(num_layers=4), device="cpu")
    sparams = params_from_jax(serve_params, smodel.cfg, device="cpu")
    tok = C.NumberTokenizer()
    one["score"] = api.generate_and_post_process(
        smodel, sparams, tok, prompts, tokens_to_generate=0)[2]
    one["greedy"] = api.generate_and_post_process(
        smodel, sparams, tok, prompts[:1], tokens_to_generate=4,
        top_k_sampling=1)[3]

    corpus = _corpus(str(tmp_path_factory.mktemp("cp_corpus") / "A"), 0)
    ft = FT + ["--data_path", corpus]
    ft_init = jax.tree.map(np.asarray, JaxLlama(dataclasses.replace(
        cfg, num_attention_heads=4, seq_length=32,
        max_position_embeddings=32)).init(jax.random.key(1)))
    one["ft"] = torch_ranks.finetune_runs([ft], ft_init)
    ft_ranks = _torchrun(tmp_path_factory.mktemp("cp_torchrun"),
                         [ft + FT_CP], ft_init)
    return {"jax": jax_out, "jax_train": jax_train, "port2": port2,
            "port4": port4, "port8": port8, "one": one,
            "ft_ranks": ft_ranks}


@pytest.mark.parametrize("group,i,name", [
    (f"port{n}", i, c[0]) for n, cases in ((2, MODEL2), (4, MODEL4),
                                           (8, MODEL8))
    for i, c in enumerate(cases)], ids=[c[0] for c in MODEL2 + MODEL4
                                        + MODEL8])
def test_loss_and_grads_match_jax_at_the_same_layout(results, group, i, name):
    want_loss, want_grads = results["jax"][name]
    got = [r[0][i] for r in results[group]]
    assert len({g["loss"] for g in got}) == 1
    np.testing.assert_allclose(got[0]["loss"], want_loss, rtol=1e-5)
    _assert_trees_close(got[0]["grads"], want_grads)


def test_pp2_cp2_pipelined_loss_and_grads_match_jax(results):
    want_loss, want_grads = results["jax"]["pp2-cp2"]
    got = [r[1][0] for r in results["port4"]]
    assert len({g["loss"] for g in got}) == 1
    np.testing.assert_allclose(got[0]["loss"], want_loss, rtol=1e-5)
    _assert_trees_close(got[0]["grads"], want_grads)


def test_the_shards_loss_counts_differ():
    """The masked cases are only a test of the sums if the shards hold
    different token counts."""
    data = _data(np.random.RandomState(0))
    for key in ("masked", "packed"):
        m = data[key]["loss_mask"]
        assert m[:, :SEQ // 2].sum() != m[:, SEQ // 2:].sum(), key


def _train(results, name):
    group = "port2" if name in dict((t[0], 0) for t in TRAIN2) else "port4"
    return [r[1 if group == "port2" else 2][name] for r in results[group]]


def _assert_steps(log, want, rtol=1e-5):
    assert len(log) == len(want)
    for got, exp in zip(log, want):
        np.testing.assert_allclose(got["loss"], exp["loss"], rtol=rtol)
        np.testing.assert_allclose(got["grad_norm"], exp["grad_norm"],
                                   rtol=rtol)


@pytest.mark.parametrize("name", [t[0] for t in TRAIN2 + TRAIN4])
def test_three_trainer_steps_match_the_jax_trainer(results, name):
    ranks = _train(results, name)
    want = results["jax_train"]
    for r in ranks:
        assert r["log"] == ranks[0]["log"]
    _assert_steps(ranks[0]["log"], want["log"])
    _assert_trees_close(ranks[0]["params"], want["params"])


@pytest.mark.parametrize("name", [t[0] for t in TRAIN2 + TRAIN4])
def test_trainer_evaluate_at_cp2(results, name):
    ranks = _train(results, name)
    assert len({r["eval"] for r in ranks}) == 1
    np.testing.assert_allclose(ranks[0]["eval"], results["jax_train"]["eval"],
                               rtol=1e-5)


@pytest.mark.parametrize("run", ["cp2-from-cp2", "cp1-from-cp2",
                                 "cp2-from-cp1"])
def test_checkpoints_resume_across_cp_layouts(results, run):
    """Steps 2 and 3 resumed from step 1's checkpoint with its Adam
    moments and step count (step 3 and the params depend on them)."""
    want = results["jax_train"]
    ranks = [r[1] for r in results["port2"]]
    if run == "cp2-from-cp2":
        got = ranks[0]["cp2"] and ranks[0]["resumed"]
        assert ranks[1]["resumed"]["log"] == got["log"]
    elif run == "cp1-from-cp2":
        got = results["one"]["from_cp2"]
    else:
        got = results["port2"][0][2]
        assert results["port2"][1][2]["log"] == got["log"]
    _assert_steps(got["log"], want["log"][1:])
    _assert_trees_close(got["params"], want["params"])
    assert len(results["one"]["saved"]) == 1


def test_refusals(results):
    got = results["port2"][0][3]
    assert "doc_start" in got["dense_mask"]
    assert "attention_dropout == 0" in got["dropout"]
    assert "pass its global position_ids" in got["positions"]
    assert "sum loss_terms over the cp group" in got["loss"]
    base = "--model_name {} --num_layers 2 --seq_length 64 " \
        "--context_parallel_size {}"
    args = arguments.build_base_parser().parse_args(
        base.format("bert", 2).split())
    with pytest.raises(SystemExit, match="padding masks"):
        arguments.args_to_configs(args, 256, world_size=2)
    args = arguments.build_base_parser().parse_args(
        base.format("llama2", 3).split())
    with pytest.raises(ValueError, match="does not divide --seq_length"):
        arguments.args_to_configs(args, 256, world_size=3)


def test_the_parser_takes_the_recipes_cp_flag():
    args = arguments.build_base_parser().parse_args(
        "--model_name codellama --num_layers 2 --seq_length 128 "
        "--micro_batch_size 1 --global_batch_size 4 "
        "--context_parallel_size 2 --tensor_model_parallel_size 2".split())
    _, pcfg, _, _ = arguments.args_to_configs(args, 256, world_size=8)
    assert pcfg.mesh_shape == (2, 1, 2, 2)
    assert pcfg.world_size == 8 and pcfg.num_microbatches == 2
    ParallelConfig(context_parallel_size=4, pipeline_parallel_size=2)


@pytest.mark.parametrize("group,layout", [("port2", "cp2"),
                                          ("port4", "pp2-cp2")],
                         ids=["cp2", "pp2-cp2"])
def test_the_api_scores_through_the_ring(results, group, layout):
    """63 positions padded to 64 over cp 2: the JAX package's scores at
    the same layout within 1e-5 (`_jax_api`), and the port's one-rank
    scorer's too."""
    want = results["jax"]["api"][layout]["score"]
    for r in results[group]:
        got = r[SCORES[group]]["score"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, results["one"]["score"], rtol=1e-5,
                                   atol=1e-5)


def test_the_api_generates_on_every_cp_rank(results):
    """Greedy tokens equal to the JAX package's generation at cp 2, and
    to the port's one-rank route."""
    want = results["jax"]["api"]["cp2"]["greedy"]
    for r in results["port2"]:
        got = r[SCORES["port2"]]["greedy"]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, results["one"]["greedy"])


@pytest.mark.parametrize("policy", ["full", "selective", "save_dots",
                                    "offload", "none"])
def test_recompute_policies_run_the_ring_hops_as_predicted(results, policy):
    """The flash forward of each visible hop runs once, and again in the
    recompute under "full" only: the named-save-point policies keep the
    hops' outputs ("attn_ctx", "flash_lse"). The backward runs each
    visible hop once; cp rank 1 has its diagonal (causal) and rank 0's
    block (full), rank 0 its diagonal alone. The loss is the same under
    every policy."""
    ranks = [r[5] for r in results["port2"]]
    n = 2 if policy == "full" else 1
    for r, got in enumerate(ranks):
        want_f = {"causal": n, **({"full": n} if r else {})}
        want_b = {"causal": 1, **({"full": 1} if r else {})}
        assert got[policy]["fwd"] == want_f, (r, got[policy])
        assert got[policy]["bwd"] == want_b, (r, got[policy])
        assert got[policy]["loss"] == got["none"]["loss"]


def test_finetune_under_torchrun_at_cp2_matches_world_size_1(results):
    want = results["one"]["ft"]["runs"][0]["steps"]
    assert [s[0] for s in want] == [1, 2, 3]
    for rank in results["ft_ranks"]:
        assert rank["jax_modules"] == []
        steps = rank["runs"][0]["steps"]
        assert [s[0] for s in steps] == [1, 2, 3]
        for g, w in zip(steps, want):
            np.testing.assert_array_equal(g[3], w[3])  # the same rows
            assert abs(g[1] - w[1]) <= 1e-5 * abs(w[1]), (g[1], w[1])
            assert abs(g[2] - w[2]) <= 1e-5 * w[2], (g[2], w[2])
