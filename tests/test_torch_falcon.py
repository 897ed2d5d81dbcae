"""PyTorch port, Falcon (models/falcon.py and the parallel-attention layer
of models/transformer.py) on the CPU in fp32 against the JAX package's
`FalconModel` on shared weights (JAX init -> numpy -> `params_from_jax`),
7B-style (multi-query, one norm) and 40B-style (grouped, parallel
layernorm):

- the parameter tree's names and shapes equal the JAX package's;
- the no-cache forward and the dense-cache decode (prefill, then
  single-token steps; the JAX side runs its Pallas decode kernel under
  the interpreter) within 1e-4;
- the port's `DecodeEngine` chunked, whole-prompt, speculative and with
  int8 pools and weights (`qdot` on Falcon's gelu MLP): the same traffic
  gives the JAX engine's greedy streams and exactly its page accounting;
- `finetune --model_name falcon`: the same argv gives equal configs,
  and 3 steps resumed from the JAX package's checkpoint give the JAX
  trainer's losses within 1e-5; `--use_post_ln` builds the JAX config.
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
from megatron_llm_tpu.config import falcon_config as jax_falcon_config
from megatron_llm_tpu.inference.engine import DecodeEngine as JaxEngine
from megatron_llm_tpu.models import FalconModel as JaxFalcon
from megatron_llm_tpu.optimizer import init_optimizer_state as jax_init_opt
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.training import checkpointing as jax_ckpt
from megatron_llm_tpu.training.trainer import Trainer as JaxTrainer
from megatron_llm_tpu_torch import arguments, finetune
from megatron_llm_tpu_torch.config import falcon_config
from megatron_llm_tpu_torch.convert.from_jax import (
    checkpoint_from_jax,
    params_from_jax,
)
from megatron_llm_tpu_torch.inference.engine import DecodeEngine
from megatron_llm_tpu_torch.models import FalconModel
from megatron_llm_tpu_torch.training.checkpointing import flatten
from megatron_llm_tpu_torch.training.trainer import Trainer
from torch_parity import close, t

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"7b_mqa": dict(num_attention_heads_kv=1),
            "40b_grouped": dict(num_attention_heads_kv=2,
                                parallel_layernorm=True)}
TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=8,
            ffn_hidden_size=256, seq_length=64, max_position_embeddings=64,
            vocab_size=256)


def _pair(variant, jax_kernel=False):
    """(jax model, jax params, port model, port params) on shared
    weights, fp32 compute."""
    kw = dict(TINY, **VARIANTS[variant])
    extra = dict(use_decode_attn=True, decode_attn_min_cache=0,
                 decode_attn_interpret=True) if jax_kernel else {}
    jm = JaxFalcon(jax_falcon_config(7, compute_dtype=jnp.float32, **kw,
                                     **extra))
    jp = jm.init(jax.random.key(11))
    tm = FalconModel(falcon_config(7, compute_dtype=torch.float32, **kw),
                     device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("variant", VARIANTS)
def test_parameter_tree_equals_jax(variant):
    jm, jp, tm, _ = _pair(variant)
    ours = {k: tuple(v.shape) for k, v in flatten(tm.init(seed=0)).items()}
    ref = {k: tuple(v.shape) for k, v in flatten(
        jax.tree.map(np.asarray, jp)).items()}
    assert ours == ref
    assert ("layers.mlp_norm.scale" in ours) == (variant == "40b_grouped")
    assert not any(k.startswith("layers.post_attention_norm") for k in ours)
    assert "lm_head" not in ours  # tied


@pytest.mark.parametrize("variant", VARIANTS)
def test_no_cache_forward(variant):
    jm, jp, tm, tp = _pair(variant)
    toks = np.random.RandomState(1).randint(0, 256, (2, 13)).astype(np.int32)
    got, _ = tm.forward(tp, t(toks).long())
    ref, _ = jm.forward(jp, jnp.asarray(toks))
    close(got, ref, 1e-4)


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_then_dense_decode_steps(variant):
    jm, jp, tm, tp = _pair(variant, jax_kernel=True)
    toks = np.random.RandomState(2).randint(0, 256, (2, 12)).astype(np.int32)
    jdp, tdp = jm.prepare_decode_params(jp), tm.prepare_decode_params(tp)
    jc = jm.init_kv_caches(2, 32, layout="layers")
    tc = tm.init_kv_caches(2, 32)
    step = jax.jit(lambda p, x, c: jm.forward(p, x, kv_caches=c))
    for lo, hi in [(0, 5)] + [(i, i + 1) for i in range(5, 12)]:
        ref, jc = step(jdp, jnp.asarray(toks[:, lo:hi]), jc)
        got, tc = tm.forward(tdp, t(toks[:, lo:hi]).long(), kv_caches=tc)
        close(got, ref, 1e-4, f"positions {lo}:{hi}")


def _accounting(eng):
    c = eng.counters()
    keys = ("serve_admitted", "serve_retired", "serve_steps",
            "serve_prefill_tokens", "serve_pages_free", "serve_pages_in_use",
            "serve_spec_proposed", "serve_spec_accepted")
    return {k: c.get(k) for k in keys}, sorted(eng._free_pages)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", ["chunked", "whole_prompt", "spec", "int8"])
def test_engine_streams_equal_jax(variant, mode):
    jm, jp, tm, tp = _pair(variant)
    kw = dict(slots=2, page_size=16, max_context=64, max_queue=8,
              termination_id=None, vocab_size=256, prefill_chunk_tokens=8)
    kw.update({"chunked": {}, "whole_prompt": dict(prefill_chunk_tokens=0),
               "spec": dict(spec_decode_k=4),
               "int8": dict(kv_dtype="int8", quantize_weights=True)}[mode])
    rs = np.random.RandomState(3)
    prompts = [[int(x) for x in rs.randint(2, 256, n)] for n in (5, 19, 3, 9)]
    # a repeating prompt gives the drafter something to propose
    prompts.append([7, 9, 11, 7, 9, 11, 7, 9])
    gens = (6, 5, 9, 4, 12)
    streams = []
    engines = [JaxEngine(jm, jp, **kw), DecodeEngine(tm, tp, **kw)]
    for eng in engines:
        reqs = [eng.submit(p, g, top_k=1, return_log_probs=True)
                for p, g in zip(prompts, gens)]
        eng.drain()
        streams.append([r.result(timeout=30) for r in reqs])
    for (jt, jl), (pt, pl) in zip(*streams):
        assert [int(x) for x in jt] == [int(x) for x in pt]
        close(pl, jl, 1e-4)
    assert _accounting(engines[0]) == _accounting(engines[1])
    assert engines[1].counters()["serve_pages_in_use"] == 0


# ---------------------------------------------------------------------------
# finetune --model_name falcon
# ---------------------------------------------------------------------------

ARGV = ("--model_name falcon --num_layers 2 --hidden_size 64 "
        "--num_attention_heads 4 --num_attention_heads_kv 1 "
        "--ffn_hidden_size 256 --seq_length 32 --micro_batch_size 2 "
        "--global_batch_size 4 --lr 1e-3 --lr_decay_style cosine "
        "--lr_warmup_iters 1 --tokenizer_type NullTokenizer "
        "--null_vocab_size 255 --split 98,2,0 --eval_interval 3 "
        "--eval_iters 1 --log_interval 1 --recompute_granularity full "
        "--data_parallel_size 1 --seed 3")


@pytest.mark.parametrize("extra", ["", "--num_attention_heads_kv 2 "
                                       "--parallel_layernorm"])
def test_same_argv_same_falcon_config(extra):
    argv = (ARGV + " " + extra).split()
    jm = jax_args.args_to_configs(
        jax_args.build_base_parser().parse_args(argv), 256)[0]
    pm = arguments.args_to_configs(
        arguments.build_base_parser().parse_args(argv), 256)[0]
    jd, pd = dataclasses.asdict(jm), dataclasses.asdict(pm)
    shared = sorted(set(jd) & set(pd) - {"params_dtype", "compute_dtype"})
    assert {"parallel_attn", "parallel_layernorm", "use_rms_norm",
            "tie_embed_logits", "hidden_act"} <= set(shared)
    assert {k: pd[k] for k in shared} == {k: jd[k] for k in shared}
    assert pm.parallel_attn and pm.parallel_layernorm == bool(extra)
    assert isinstance(finetune.model_provider(
        arguments.build_base_parser().parse_args(argv), pm, device="cpu"),
        FalconModel)


def test_post_ln_still_raises():
    """Post-LN layers are ported (the encoder family's slice): the flag
    no longer raises and builds the JAX package's config field for field
    (a parallel-attention layer has no post-LN branch in either
    package)."""
    argv = (ARGV + " --use_post_ln").split()
    jm = jax_args.args_to_configs(
        jax_args.build_base_parser().parse_args(argv), 256)[0]
    pm = arguments.args_to_configs(
        arguments.build_base_parser().parse_args(argv), 256)[0]
    jd, pd = dataclasses.asdict(jm), dataclasses.asdict(pm)
    shared = sorted(set(jd) & set(pd) - {"params_dtype", "compute_dtype"})
    assert "use_post_ln" in shared
    assert {k: pd[k] for k in shared} == {k: jd[k] for k in shared}
    assert pm.use_post_ln and pm.parallel_attn


@pytest.fixture(autouse=True)
def _no_jax_context_left():
    """The JAX `finetune.main` installs its parallel context for the
    process and leaves it there: drop it after each test, so that a later
    test in the same worker (a JAX harness on other devices) does not
    inherit a one-device mesh."""
    yield
    from megatron_llm_tpu.parallel.mesh import destroy_parallel

    destroy_parallel()


def _jax_finetune():
    spec = importlib.util.spec_from_file_location(
        "jax_finetune_entry", os.path.join(REPO, "finetune.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _corpus(tmp_path, name, seed, n_docs=200, vocab=255):
    from megatron_llm_tpu.data import indexed_dataset as jax_idx

    rs = np.random.RandomState(seed)
    prefix = str(tmp_path / name)
    b = jax_idx.MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    for _ in range(n_docs):
        b.add_item(np.append(rs.randint(0, vocab, rs.randint(4, 60)), vocab))
        b.end_document()
    b.finalize(prefix + ".idx")
    return prefix


def _fp32(args_to_configs, dtype):
    def wrapped(args, vocab):
        m, p, tc, d = args_to_configs(args, vocab)
        return dataclasses.replace(m, compute_dtype=dtype), p, tc, d
    return wrapped


def _record(monkeypatch, cls, log):
    inner = cls.train_step

    def train_step(self, state, text, *a, **kw):
        stats = inner(self, state, text, *a, **kw)
        log.append((state.iteration, float(stats["loss"]), np.array(text)))
        return stats

    monkeypatch.setattr(cls, "train_step", train_step)


def test_finetune_falcon_equals_the_jax_trainer(tmp_path, monkeypatch):
    """The JAX `finetune.main` trains a tiny Falcon 0 -> 3 and saves; the
    port's `finetune.main` resumes that checkpoint 3 -> 6 beside the JAX
    one: the same batches, losses within 1e-5 (fp32)."""
    jft = _jax_finetune()
    monkeypatch.setattr(jft, "args_to_configs",
                        _fp32(jft.args_to_configs, jnp.float32))
    monkeypatch.setattr(finetune, "args_to_configs",
                        _fp32(finetune.args_to_configs, torch.float32))
    base = ARGV.split() + ["--data_path", _corpus(tmp_path, "A", 0)]
    jdir, pdir = str(tmp_path / "jax_ck"), str(tmp_path / "port_ck")
    jft.main(base + ["--train_iters", "3", "--save", jdir,
                     "--save_interval", "3"])

    argv = base + ["--train_iters", "6"]
    mcfg = jft.args_to_configs(
        jax_args.build_base_parser().parse_args(argv), 256)[0]
    tmpl = JaxFalcon(mcfg).init(jax.random.key(0))
    params, opt, meta, it = jax_ckpt.load_checkpoint(
        jdir, tmpl, jax_init_opt(tmpl, JaxTrainConfig()), mcfg)
    assert it == 3
    checkpoint_from_jax(jax.tree.map(np.asarray, params),
                        jax.tree.map(np.asarray, opt), meta, pdir)

    jax_run, port_run = [], []
    _record(monkeypatch, JaxTrainer, jax_run)
    jft.main(argv + ["--load", jdir])
    _record(monkeypatch, Trainer, port_run)
    state = finetune.main(argv + ["--load", pdir], device="cpu")
    assert state.iteration == 6
    assert [r[0] for r in port_run] == [r[0] for r in jax_run] == [4, 5, 6]
    for (_, jl, jt), (pi, pl, pt) in zip(jax_run, port_run):
        np.testing.assert_array_equal(pt, jt)
        assert abs(pl - jl) <= 1e-5, (pi, pl, jl)
    assert len({round(r[1], 6) for r in port_run}) == 3
