"""PyTorch port, the training entry path against the JAX package's.

- the two parsers carry the same options, destinations, defaults, nargs
  and choices, and the same audit buckets;
- the same argv gives equal configs, field by field, for llama2,
  codellama and gpt, and for each single-card training mode's flags
  (fp16 and its loss scalers, dropout and LIMA, the recompute policies
  and block recompute); flags of later slices raise, naming the slice;
- entry parity: the JAX `finetune.main` trains a tiny Llama 0 -> 3 on a
  blend of two corpora and saves; that save, restored with the JAX
  loader and written through `checkpoint_from_jax`, resumes the port's
  `finetune.main` 3 -> 6 beside the JAX one resuming its own: the same
  tokens, the same consumed samples, losses within 1e-5 (fp32);
- SIGTERM kill-and-resume of the port's `finetune.main` in
  subprocesses: the emergency save, then a fresh process resumes and
  reproduces the uninterrupted run's losses and final checkpoint bit
  for bit;
- the loss watchdog's rollback end to end, and AutoResume's
  save-and-exit.
"""

import dataclasses
import importlib.util
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu import arguments as jax_args
from megatron_llm_tpu.config import ModelConfig as JaxModelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.data import indexed_dataset as jax_idx
from megatron_llm_tpu.models import LlamaModel as JaxLlama
from megatron_llm_tpu.optimizer import init_optimizer_state as jax_init_opt
from megatron_llm_tpu.training import checkpointing as jax_ckpt
from megatron_llm_tpu.training.trainer import Trainer as JaxTrainer
from megatron_llm_tpu_torch import arguments, finetune
from megatron_llm_tpu_torch.config import ModelConfig, TrainConfig
from megatron_llm_tpu_torch.config import ParallelConfig, tiny_config
from megatron_llm_tpu_torch.convert.from_jax import checkpoint_from_jax
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
from megatron_llm_tpu_torch.training.checkpointing import (
    checkpoint_dir,
    is_checkpoint_complete,
    read_tracker,
)
from megatron_llm_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# ---------------------------------------------------------------------------
# the parsers and the configs
# ---------------------------------------------------------------------------


def _actions(parser):
    return {tuple(a.option_strings): (a.dest, a.default, a.nargs, a.const,
                                      tuple(a.choices or ()), a.type)
            for a in parser._actions if a.option_strings}


# the port's one divergence from the JAX flag surface: torch needs a
# collective backend, which the JAX package accepts and ignores
PORT_ONLY = ("--distributed_backend",)


def test_parsers_carry_the_same_options():
    j = _actions(jax_args.build_base_parser())
    p = _actions(arguments.build_base_parser())
    assert set(j) == set(p)
    for opts in j:
        if opts[0] in PORT_ONLY:
            assert p[opts][0] == opts[0].lstrip("-")
            assert p[opts][4] == ("nccl", "gloo")
            continue
        assert j[opts] == p[opts], opts
    assert len(p) > 150


def test_audit_buckets_equal():
    assert set(arguments.SUBSUMED_FLAGS) == set(jax_args.SUBSUMED_FLAGS) \
        - set(PORT_ONLY)
    assert set(arguments.DESCOPED_FLAGS) == set(jax_args.DESCOPED_FLAGS)
    assert arguments.ENTRY_SCRIPT_FLAGS == jax_args.ENTRY_SCRIPT_FLAGS
    # every later-slice flag is a real option of the parser
    dests = {a.dest for a in arguments.build_base_parser()._actions}
    assert set(arguments.LATER_FLAGS) <= dests


def _value(v):
    """Field values across packages: dtypes by name."""
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    if isinstance(v, type) or hasattr(v, "dtype"):
        return jnp.dtype(v).name
    return v


def _same_fields(port, ref, cls_port, cls_ref):
    names = ({f.name for f in dataclasses.fields(cls_port)}
             & {f.name for f in dataclasses.fields(cls_ref)})
    assert len(names) > 10
    for n in sorted(names):
        assert _value(getattr(port, n)) == _value(getattr(ref, n)), n
    return names


COMMON = ("--seq_length 256 --micro_batch_size 2 --global_batch_size 8 "
          "--train_iters 10 --lr 3e-4 --lr_decay_style cosine "
          "--lr_warmup_iters 2 --weight_decay 0.1 --adam_beta2 0.95 "
          "--clip_grad 0.5 --save /tmp/s --load /tmp/l --save_interval 5 "
          "--keep_latest_n 2 --no_async_save --finetune --no_load_optim "
          "--exit_signal_handler --autoresume_file /tmp/ar "
          "--autoresume_interval 3 --spike_rollback_patience 2 "
          "--loss_watchdog_ksigma 3 --data_path 0.5 a 0.5 b --split 9,1,0 "
          "--seed 7 --eval_interval 5 --eval_iters 2 --log_interval 1 "
          "--data_parallel_size 1 --timing_log_level 1 --bf16")


@pytest.mark.parametrize("model_args", [
    "--model_name llama2 --model_size 7 --num_layers 4 "
    "--recompute_granularity full",
    "--model_name llama --model_size 13 --num_layers 2 --no_use_flash_attn",
    "--model_name codellama --model_size 34 --num_layers 2 "
    "--remat_policy full --rope_theta 5e5",
    "--model_name gpt --num_layers 3 --hidden_size 256 "
    "--num_attention_heads 8 --hidden_dropout 0 --attention_dropout 0 "
    "--no_tie_embed_logits --max_position_embeddings 512",
])
@pytest.mark.parametrize("vocab", [0, 32000, 50257])
def test_same_argv_same_configs(model_args, vocab):
    argv = (model_args + " " + COMMON).split()
    ja = jax_args.build_base_parser().parse_args(argv)
    pa = arguments.build_base_parser().parse_args(argv)
    jm, jp, jt, jd = jax_args.args_to_configs(ja, vocab)
    pm, pp, pt, pd = arguments.args_to_configs(pa, vocab)
    shared = _same_fields(pm, jm, ModelConfig, JaxModelConfig)
    assert {"compute_dtype", "padded_vocab_size", "use_flash_attn",
            "recompute_granularity", "rope_theta"} <= shared
    # the JAX-only fields stay at what the port runs
    assert not (jm.use_post_ln or jm.parallel_attn or jm.lima_dropout)
    assert pm.resolved_remat_policy == jm.resolved_remat_policy
    _same_fields(pt, jt, TrainConfig, JaxTrainConfig)
    assert (pp.num_microbatches, pp.data_parallel_size) == (
        jp.num_microbatches, jp.data_parallel_size)
    assert dataclasses.asdict(pd) == dataclasses.asdict(jd)


@pytest.mark.parametrize("flags,slice_name", [
    ("--overlap_grad_reduce", "A4"),
    ("--overlap_param_gather", "A4"),
    ("--async_pipeline_dispatch", "A4"),
    ("--pipeline_model_parallel_size 2 --async_pipeline_dispatch", "A4"),
    ("--tensorboard_dir /tmp/tb", "A3.8"),
    ("--wandb_logger", "A3.8"),
    ("--profile", "A3.8"),
    ("--trace_dir /tmp/tr", "A3.8"),
    ("--flight_record_dir /tmp/fr", "A3.8"),
    ("--perf_sentinel_ksigma 3", "A3.8"),
    ("--use_post_ln", "A6"),
])
def test_later_slice_flags_raise_by_name(flags, slice_name):
    argv = f"--model_name llama2 --num_layers 2 {flags}".split()
    args = arguments.build_base_parser().parse_args(argv)
    with pytest.raises(ValueError, match=slice_name.replace(".", r"\.")):
        arguments.args_to_configs(args, 32000)


@pytest.mark.parametrize("flags", [
    "--fp16",
    "--loss_scale 1024",
    "--hidden_dropout 0.1",
    "--attention_dropout 0.05",
    "--lima_dropout",
    "--remat_policy selective",
    "--recompute_activations",
    "--recompute_granularity full --recompute_method block",
    "--fp16 --loss_scale 4096 --hysteresis 3",
    "--fp16 --initial_loss_scale 65536 --min_loss_scale 2 "
    "--loss_scale_window 10 --hysteresis 1",
    "--hidden_dropout 0.1 --attention_dropout 0.1 --lima_dropout",
    "--remat_policy save_dots",
    "--remat_policy offload --recompute_method block "
    "--recompute_num_layers 1",
    "--recompute_granularity selective --recompute_method block "
    "--recompute_num_layers 2",
])
def test_training_mode_flags_build_the_jax_configs(flags):
    """The flags of the single-card training modes, once refused by
    name, build the configs the JAX parser builds, field by field:
    fp16 (fp16 compute on fp32 params) and the loss scaler's fields,
    the dropout rates and LIMA, the recompute policy, method and layer
    count."""
    argv = (f"--model_name llama2 --num_layers 2 {flags} "
            "--data_parallel_size 1").split()
    ja = jax_args.build_base_parser().parse_args(argv)
    pa = arguments.build_base_parser().parse_args(argv)
    jm, jp, jt, _ = jax_args.args_to_configs(ja, 32000)
    pm, pp, pt, _ = arguments.args_to_configs(pa, 32000)
    shared = _same_fields(pm, jm, ModelConfig, JaxModelConfig)
    assert {"compute_dtype", "params_dtype", "hidden_dropout",
            "attention_dropout", "lima_dropout", "recompute_granularity",
            "remat_policy", "recompute_method",
            "recompute_num_layers"} <= shared
    assert pm.resolved_remat_policy == jm.resolved_remat_policy
    train = _same_fields(pt, jt, TrainConfig, JaxTrainConfig)
    assert {"fp16", "bf16", "loss_scale", "initial_loss_scale",
            "min_loss_scale", "loss_scale_window", "hysteresis"} <= train
    assert pm.compute_dtype == (torch.float16 if "--fp16" in flags
                                else torch.bfloat16)


@pytest.mark.parametrize("name", ["bert", "t5"])
def test_model_families_of_later_slices_raise(name):
    args = arguments.build_base_parser().parse_args(
        ["--model_name", name, "--num_layers", "2"])
    with pytest.raises(ValueError, match="A6"):
        arguments.args_to_configs(args, 32000)


def test_descoped_flag_exits_with_reason():
    args = arguments.build_base_parser().parse_args(["--onnx_safe"])
    with pytest.raises(SystemExit, match="onnx_safe"):
        arguments.args_to_configs(args, 32000)


# ---------------------------------------------------------------------------
# entry parity with the JAX package
# ---------------------------------------------------------------------------


def _corpus(tmp_path, name, seed, n_docs=200, vocab=255):
    rs = np.random.RandomState(seed)
    prefix = str(tmp_path / name)
    b = jax_idx.MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    for _ in range(n_docs):
        b.add_item(np.append(rs.randint(0, vocab, rs.randint(4, 60)), vocab))
        b.end_document()
    b.finalize(prefix + ".idx")
    return prefix


TINY_ARGV = ("--model_name llama2 --num_layers 2 --hidden_size 64 "
             "--num_attention_heads 4 --num_attention_heads_kv 2 "
             "--ffn_hidden_size 128 --seq_length 32 --micro_batch_size 2 "
             "--global_batch_size 4 --lr 1e-3 --lr_decay_style cosine "
             "--lr_warmup_iters 1 --tokenizer_type NullTokenizer "
             "--null_vocab_size 255 --split 98,2,0 --eval_interval 3 "
             "--eval_iters 1 --log_interval 1 --recompute_granularity full "
             "--data_parallel_size 1 --seed 3")


def _fp32(args_to_configs, dtype):
    def wrapped(args, vocab):
        m, p, t, d = args_to_configs(args, vocab)
        return dataclasses.replace(m, compute_dtype=dtype), p, t, d
    return wrapped


def _record(monkeypatch, cls, log):
    inner = cls.train_step

    def train_step(self, state, text, *a, **kw):
        stats = inner(self, state, text, *a, **kw)
        log.append((state.iteration, float(stats["loss"]),
                    np.array(text), state.consumed_train_samples))
        return stats

    monkeypatch.setattr(cls, "train_step", train_step)


def test_entry_parity_jax_to_port(tmp_path, monkeypatch):
    jft = _jax_finetune()
    monkeypatch.setattr(jft, "args_to_configs",
                        _fp32(jft.args_to_configs, jnp.float32))
    monkeypatch.setattr(finetune, "args_to_configs",
                        _fp32(finetune.args_to_configs, torch.float32))
    a, b = _corpus(tmp_path, "A", 0), _corpus(tmp_path, "B", 1)
    base = TINY_ARGV.split() + ["--data_path", "0.7", a, "0.3", b]
    jdir, pdir = str(tmp_path / "jax_ck"), str(tmp_path / "port_ck")

    first = []
    _record(monkeypatch, JaxTrainer, first)
    jft.main(base + ["--train_iters", "3", "--save", jdir,
                     "--save_interval", "3"])
    assert [r[0] for r in first] == [1, 2, 3]

    # the JAX save, restored by the JAX loader, into a port checkpoint
    argv = base + ["--train_iters", "6"]
    mcfg = jft.args_to_configs(
        jax_args.build_base_parser().parse_args(argv), 256)[0]
    model = JaxLlama(mcfg)
    tmpl = model.init(jax.random.key(0))
    opt_tmpl = jax_init_opt(tmpl, JaxTrainConfig())
    params, opt, meta, it = jax_ckpt.load_checkpoint(jdir, tmpl, opt_tmpl,
                                                     mcfg)
    assert it == 3
    checkpoint_from_jax(jax.tree.map(np.asarray, params),
                        jax.tree.map(np.asarray, opt), meta, pdir)
    assert read_tracker(pdir) == (3, False)

    jax_run, port_run = [], []
    _record(monkeypatch, JaxTrainer, jax_run)
    jft.main(argv + ["--load", jdir])
    _record(monkeypatch, Trainer, port_run)
    state = finetune.main(argv + ["--load", pdir], device="cpu")

    assert state.iteration == 6 and state.consumed_train_samples == 24
    assert [r[0] for r in port_run] == [r[0] for r in jax_run] == [4, 5, 6]
    for (ji, jl, jt, jc), (pi, pl, pt, pc) in zip(jax_run, port_run):
        np.testing.assert_array_equal(pt, jt)
        assert pc == jc
        assert abs(pl - jl) <= 1e-5, (pi, pl, jl)
    # the losses moved: a resume that dropped the state would not agree
    assert len({round(r[1], 6) for r in port_run}) == 3


# ---------------------------------------------------------------------------
# SIGTERM kill-and-resume in subprocesses
# ---------------------------------------------------------------------------

TRAIN_ITERS = 9

CHILD = textwrap.dedent("""
    import os, sys, time
    import torch
    torch.set_num_threads(1)
    from megatron_llm_tpu_torch import finetune
    from megatron_llm_tpu_torch.training.trainer import Trainer

    workdir, data, delay = sys.argv[1], sys.argv[2], float(sys.argv[3])
    inner = Trainer.train_step

    def train_step(self, state, text, *a):
        time.sleep(delay)
        stats = inner(self, state, text, *a)
        with open(os.path.join(workdir, "losses.txt"), "a") as f:
            f.write(f"STEP {state.iteration} {float(stats['loss']).hex()}"
                    "\\n")
            f.flush()
            os.fsync(f.fileno())
        return stats

    Trainer.train_step = train_step
    ck = os.path.join(workdir, "ckpt")
    argv = sys.argv[4].split() + ["--data_path", data, "--save", ck,
                                  "--load", ck]
    state = finetune.main(argv, device="cpu")
    print(f"DONE iter={state.iteration} "
          f"consumed={state.consumed_train_samples}", flush=True)
""")


def _child_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


def _losses(workdir):
    path = os.path.join(workdir, "losses.txt")
    if not os.path.exists(path):
        return {}
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 3 and parts[0] == "STEP":
                out[int(parts[1])] = parts[2]
    return out


def test_kill_and_resume_bitwise(tmp_path):
    data = _corpus(tmp_path, "C", 2)
    argv = (TINY_ARGV + f" --train_iters {TRAIN_ITERS} --save_interval 2 "
            "--keep_latest_n 2 --exit_signal_handler --eval_interval 0")
    ref, kill = str(tmp_path / "ref"), str(tmp_path / "kill")
    os.makedirs(ref)
    os.makedirs(kill)

    def run(workdir, delay="0"):
        return [sys.executable, "-c", CHILD, workdir, data, delay, argv]

    r = subprocess.run(run(ref), env=_child_env(), cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    ref_losses = _losses(ref)
    assert sorted(ref_losses) == list(range(1, TRAIN_ITERS + 1))

    proc = subprocess.Popen(run(kill, "0.4"), env=_child_env(), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        deadline = time.time() + 90
        while len(_losses(kill)) < 2:
            assert proc.poll() is None, proc.stdout.read()
            assert time.time() < deadline, "child never made 2 steps"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    assert "emergency save" in out
    k = max(_losses(kill))
    assert 2 <= k <= TRAIN_ITERS - 4, out
    assert read_tracker(os.path.join(kill, "ckpt")) == (k, False)

    r2 = subprocess.run(run(kill), env=_child_env(), cwd=REPO,
                        capture_output=True, text=True, timeout=120)
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert f"DONE iter={TRAIN_ITERS} consumed={4 * TRAIN_ITERS}" in r2.stdout
    assert f"loaded checkpoint from {os.path.join(kill, 'ckpt')} at " \
           f"iteration {k}" in r2.stdout
    resumed = _losses(kill)
    assert sorted(resumed) == list(range(1, TRAIN_ITERS + 1))
    for s in range(k + 1, TRAIN_ITERS + 1):
        assert resumed[s] == ref_losses[s], s

    final = [os.path.join(d, "ckpt", f"iter_{TRAIN_ITERS:07d}")
             for d in (ref, kill)]
    for name in ("model", "optim"):
        a, b = (torch.load(os.path.join(f, name), weights_only=True)
                for f in final)
        assert set(a) == set(b)
        for leaf in a:
            assert torch.equal(a[leaf], b[leaf]), (name, leaf)
    metas = [json.load(open(os.path.join(f, "meta.json"))) for f in final]
    assert metas[0]["consumed_train_samples"] == \
        metas[1]["consumed_train_samples"] == 4 * TRAIN_ITERS


# ---------------------------------------------------------------------------
# the watchdog's rollback and autoresume
# ---------------------------------------------------------------------------


class _PoisonLossModel:
    """A microbatch whose tokens[0, 0] == 255 gets NaN added to its
    loss."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def loss(self, params, **kw):
        base = self._inner.loss(params, **kw)
        poison = kw["tokens"][0, 0] == 255
        return base + torch.where(poison, float("nan"), 0.0)


def _tiny_model():
    return LlamaModel(tiny_config(seq_length=16, max_position_embeddings=16),
                      device="cpu")


def test_watchdog_rollback_end_to_end(tmp_path):
    """Good steps, a checkpoint at 10, two poisoned batches skipped in
    the step, the rollback to 10, and the iterator kept going: 20 batches
    consumed for 18 iterations."""
    model = _PoisonLossModel(_tiny_model())
    save_dir = str(tmp_path / "ck")
    tcfg = TrainConfig(micro_batch_size=2, global_batch_size=2, lr=1e-3,
                       train_iters=18, log_interval=100, eval_interval=0,
                       save=save_dir, save_interval=5,
                       spike_rollback_patience=2)
    rng = np.random.RandomState(0)
    batches = []
    for i in range(30):
        t = rng.randint(0, 200, size=(1, 2, 17))
        if i in (10, 11):  # iterations 11 and 12
            t[0, 0, 0] = 255
        batches.append(t.astype(np.int32))
    trainer = Trainer(model, tcfg, ParallelConfig(),
                      train_data_iterator=batches)
    state = trainer.train(trainer.setup())
    assert trainer.watchdog.skipped == 2
    assert trainer.watchdog.rollbacks == 1
    assert state.iteration == 18
    assert state.consumed_train_samples == 20 * 2
    for leaf in tree_leaves(state.params):
        assert torch.isfinite(leaf).all()
    steps = [r["step"] for r in trainer.step_log]
    assert steps[:12] == list(range(1, 13)) and steps[12] == 11
    assert [r["bad"] for r in trainer.step_log].count(True) == 2
    assert "ckpt_blocked_ms" in trainer.timers.gauges()


def test_autoresume_saves_and_exits(tmp_path):
    flag = tmp_path / "terminate"
    flag.write_text("")
    save_dir = str(tmp_path / "ck")
    tcfg = TrainConfig(micro_batch_size=2, global_batch_size=2, lr=1e-3,
                       train_iters=10, log_interval=100, eval_interval=0,
                       save=save_dir, autoresume_file=str(flag),
                       autoresume_interval=3)
    batches = [np.random.RandomState(i).randint(0, 200, (1, 2, 17))
               .astype(np.int32) for i in range(10)]
    trainer = Trainer(_tiny_model(), tcfg, ParallelConfig(),
                      train_data_iterator=batches)
    state = trainer.train(trainer.setup())
    assert state.iteration == 3
    assert not flag.exists()
    assert read_tracker(save_dir) == (3, False)
    assert is_checkpoint_complete(checkpoint_dir(save_dir, 3))
