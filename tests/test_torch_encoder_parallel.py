"""PyTorch port, the encoder family's parallel layouts against the JAX
package, on the CPU in fp32 at tiny widths (2 layers, hidden 64, 4
heads, seq 16):

- BERT (masked LM + sentence order), T5 and the ICT biencoder at tp 2,
  tp 2 + sequence parallelism, dp 2 (two gloo CPU ranks) and tp 2 x dp
  2 with sequence parallelism and ZeRO-1 (four): the global loss and
  every gathered gradient within 1e-5 of the JAX package at world size
  1, and at tp 2 x dp 2 + SP of the JAX package on its virtual CPU mesh
  at the same layout; one AdamW train step within 1e-5 of the port's at
  world size 1 (elements whose gradient is rounding noise, which Adam
  scales to about lr, within 2 lr); every rank's slice of every leaf of
  the spec tree equal to the whole leaf's block;
- ICT under dp 2: each query's softmax over the global batch's
  contexts; the rank-local softmax (no all-gather) gives another loss;
- `pretrain_bert`, `pretrain_t5` and `pretrain_ict` at tp 2 x dp 2 + SP +
  ZeRO-1 against the JAX entries at world size 1 on the same corpus and
  weights: each rank's batch bit for bit the JAX global batch's rows,
  losses within 1e-5, every rank the same loss, the save in per-rank
  files;
- MNLI and RACE finetuning through `tasks.main` at dp 2, and MNLI at
  tp 2 + SP, against the JAX loop at dp 2, losses within 1e-5 step for
  step; RET-FINETUNE-NQ with hard negatives at dp 2 and at tp 2 + SP
  against the JAX entry (losses and in-batch top-1 within 1e-5), and
  RETRIEVER-EVAL at dp 2, its evidence embedded in per-rank store
  shards, against the JAX entry's hit counts;
- the refusals: pp and cp with the JAX entries' messages, and the
  overlap and quantized-reduce flags with a batch builder.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_encoder_ranks as ranks
from megatron_llm_tpu.config import bert_config as jax_bert_config
from megatron_llm_tpu.config import t5_config as jax_t5_config
from megatron_llm_tpu.models import BertModel as JaxBert
from megatron_llm_tpu.models import T5Model as JaxT5
from megatron_llm_tpu.models.biencoder import BiEncoderModel as JaxBiEncoder
from megatron_llm_tpu.parallel.mesh import destroy_parallel as jax_destroy
from megatron_llm_tpu.parallel.mesh import (
    initialize_parallel as jax_initialize,
)
from megatron_llm_tpu.parallel.sharding import param_shardings
from megatron_llm_tpu.training.trainer import Trainer as JaxTrainer
from megatron_llm_tpu_torch.config import ParallelConfig, TrainConfig
from megatron_llm_tpu_torch.convert.from_jax import params_from_jax
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves
from megatron_llm_tpu_torch.pretrain_bert import check_encoder_layout
from megatron_llm_tpu_torch.training.train_step import make_train_step
from megatron_llm_tpu_torch.utils.virtual_mesh import spawn_cpu_group

from torch_parity import jax_native_helpers

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("bert", "t5", "ict")
TWO = [("tp2", 1, 2, False, False), ("tp2_sp", 1, 2, True, False),
       ("dp2", 2, 1, False, False)]
FOUR = [("tp2_dp2_sp_zero1", 2, 2, True, True)]


@pytest.fixture(autouse=True)
def _clean():
    jax_native_helpers()
    yield
    jax_destroy()


def _jax_model(kind):
    w = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             ffn_hidden_size=128, padded_vocab_size=128, hidden_dropout=0.0,
             attention_dropout=0.0, compute_dtype=jnp.float32,
             max_position_embeddings=ranks.SEQ)
    if kind == "t5":
        return JaxT5(jax_t5_config(seq_length=ranks.SEQ,
                                   decoder_seq_length=ranks.DEC_SEQ, **w))
    cfg = jax_bert_config(seq_length=ranks.SEQ,
                          add_binary_head=kind == "bert", **w)
    if kind == "bert":
        return JaxBert(cfg)
    return JaxBiEncoder(cfg, projection_dim=ranks.PROJ)


def _jitter(tree, seed):
    """Every leaf moved by N(0, 0.05): norms and biases off their init."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32), tree)


def _batch(kind, seed):
    rs = np.random.RandomState(seed)
    n, s, d = ranks.ROWS, ranks.SEQ, ranks.DEC_SEQ

    def keep(length, lens):
        return (np.arange(length)[None] < np.array(lens)[:, None]).astype(
            np.int32)

    def ids(length):
        return rs.randint(5, 120, (n, length)).astype(np.int32)

    if kind == "bert":
        mask = keep(s, (16, 11, 7, 16))
        return dict(tokens=ids(s), attention_mask=mask,
                    tokentype_ids=(np.arange(s)[None] >= np.array(
                        [6, 4, 2, 9])[:, None]).astype(np.int32),
                    labels=ids(s), loss_mask=(rs.rand(n, s) < 0.4).astype(
                        np.float32) * mask,
                    sop_labels=rs.randint(0, 2, (n,)).astype(np.int32))
    if kind == "t5":
        dmask = keep(d, (8, 5, 3, 6))
        return dict(encoder_input_ids=ids(s), decoder_input_ids=ids(d),
                    lm_labels=ids(d),
                    loss_mask=dmask.astype(np.float32) * (
                        rs.rand(n, d) < 0.8),
                    encoder_attn_mask=keep(s, (16, 12, 5, 9)),
                    decoder_attn_mask=dmask)
    return dict(query_tokens=ids(s), query_mask=keep(s, (9, 16, 4, 12)),
                context_tokens=ids(s), context_mask=keep(s, (16, 13, 8, 5)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_loss_and_grads(model, tree, batch, layout=None):
    """The JAX loss and gradients at world size 1, or on the virtual mesh
    at `layout` (dp, tp, sequence parallel) with the leaves sharded."""
    p = jax.tree.map(jnp.asarray, tree)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, **b)))
    if layout is None:
        loss, grads = fn(p, b)
        return float(loss), _flat(grads)
    dp, tp, sp = layout
    ctx = jax_initialize(dp=dp, pp=1, tp=tp, sequence_parallel=sp,
                         devices=jax.devices()[:dp * tp])
    try:
        p = jax.device_put(p, param_shardings(ctx, model.cfg, p))
        loss, grads = fn(p, b)
        return float(loss), _flat(grads)
    finally:
        jax_destroy()


def _layout_refs():
    """The JAX trees, the global batches, the JAX loss and gradients at
    world size 1 and on the mesh at tp 2 x dp 2 + SP, by kind."""
    trees = {k: _jitter(_jax_model(k).init(jax.random.key(i)), i)
             for i, k in enumerate(KINDS)}
    batches = {k: _batch(k, 10 + i) for i, k in enumerate(KINDS)}
    jax_ws1, jax_mesh = {}, {}
    for kind in KINDS:
        model = _jax_model(kind)
        jax_ws1[kind] = _jax_loss_and_grads(model, trees[kind],
                                            batches[kind])
        jax_mesh[kind] = _jax_loss_and_grads(model, trees[kind],
                                             batches[kind], (2, 2, True))
    return trees, batches, jax_ws1, jax_mesh


def _port_world1_steps(trees, batches):
    """The port's one AdamW train step at world size 1, by kind: (loss,
    grad norm, the whole updated tree)."""
    from megatron_llm_tpu_torch.optimizer import init_optimizer_state

    out = {}
    for kind in KINDS:
        model = ranks.port_model(kind)
        params = params_from_jax(trees[kind], model.cfg, device="cpu")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        tcfg = TrainConfig(micro_batch_size=ranks.ROWS,
                           global_batch_size=ranks.ROWS, **ranks.STEP)
        step = make_train_step(model, tcfg, ParallelConfig(),
                               batch_builder=dict)
        params, _, stats = step(
            params, init_optimizer_state(params, tcfg),
            {k: torch.from_numpy(v)[None] for k, v in
             batches[kind].items()}, ranks.STEP["lr"],
            ranks.STEP["weight_decay"])
        out[kind] = (float(stats["loss"]), float(stats["grad_norm"]),
                     _flat(jax.tree.map(lambda x: x.detach().numpy(),
                                        params)))
    return out


# ---------------------------------------------------------------------------
# the JAX runs the ranks are held to: the entries, the finetuning loops
# ---------------------------------------------------------------------------

def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fp32(inner):
    def wrapped(args, vocab, *a, **kw):
        m, p, tc, d = inner(args, vocab, *a, **kw)
        return dataclasses.replace(m, compute_dtype=jnp.float32), p, tc, d
    return wrapped


# the JAX run: one rank, 1 microbatch of 4; the port: tp 2 x dp 2, 1
# microbatch of 2 a dp rank, the same global batch of 4 samples; the
# vocabulary padded to 16 in both (8 x tp 2 in the port)
ENTRY = ("--num_layers 2 --hidden_size 64 --num_attention_heads 4 "
         "--seq_length 32 --max_position_embeddings 32 "
         "--global_batch_size 4 --lr 1e-3 --lr_decay_style linear "
         "--lr_warmup_iters 1 --tokenizer_type BertWordPieceLowerCase "
         "--log_interval 1 --hidden_dropout 0 --attention_dropout 0 "
         "--seed 5 --train_iters 2 --eval_interval 2 --eval_iters 1")
JAX_LAYOUT = ("--micro_batch_size 4 --data_parallel_size 1 "
              "--make_vocab_size_divisible_by 16")
PORT_LAYOUT = ("--micro_batch_size 2 --tensor_model_parallel_size 2 "
               "--sequence_parallel --use_distributed_optimizer "
               "--data_parallel_size 2 --make_vocab_size_divisible_by 8")
EXTRA = {"pretrain_bert": "--split 90,10,0",
         "pretrain_t5": "--split 90,10,0 --decoder_seq_length 16 "
                        "--vocab_extra_ids 10",
         "pretrain_ict": "--query_in_block_prob 0.3"}
ENTRIES = ("pretrain_bert", "pretrain_t5", "pretrain_ict")


def _entry_jobs(tmp_path, monkeypatch):
    """Runs the JAX entries, recording their batches and losses and the
    initial tree each model drew; returns (jobs for the ranks, JAX
    records by entry)."""
    from megatron_llm_tpu import arguments as jax_args
    from test_torch_biencoder import ict_corpus

    jobs, jax_runs, current = [], {}, []
    inner_step = JaxTrainer.train_step

    def train_step(self, state, text, *a, **kw):
        stats = inner_step(self, state, text, *a, **kw)
        current[0].append((state.iteration, float(stats["loss"]),
                           {k: np.array(v) for k, v in text.items()}))
        return stats

    monkeypatch.setattr(JaxTrainer, "train_step", train_step)
    for module, cls in zip(ENTRIES, (JaxBert, JaxT5, JaxBiEncoder)):
        d = tmp_path / module
        d.mkdir()
        vocab, data, titles = ict_corpus(d, n_docs=40)
        argv = ENTRY.split() + EXTRA[module].split() + [
            "--vocab_file", vocab, "--data_path", data]
        if module == "pretrain_ict":
            argv += ["--titles_data_path", titles]
        jax_entry = _load(f"jax_{module}", os.path.join(REPO,
                                                        f"{module}.py"))
        monkeypatch.setattr(jax_entry, "args_to_configs",
                            _fp32(jax_args.args_to_configs))
        drawn, log = {}, []
        inner_init = cls.init

        def init(self, key, _inner=inner_init, _drawn=drawn):
            # the trainer jits its init: draw the tree eagerly, from a
            # key of its own, and hand the jit its constants
            with jax.ensure_compile_time_eval():
                out = _jitter(_inner(self, jax.random.key(7)), 3)
            _drawn["tree"] = out
            return jax.tree.map(jnp.asarray, out)

        monkeypatch.setattr(cls, "init", init)
        current[:] = [log]
        jax_entry.main(argv + JAX_LAYOUT.split())
        jax_destroy()
        jax_runs[module] = log
        port_argv = argv + PORT_LAYOUT.split()
        if module == "pretrain_bert":
            port_argv += ["--save", str(d / "port_ck")]
        jobs.append((module, port_argv, drawn["tree"]))
    return jobs, jax_runs


def _task_jobs(tmp_path, monkeypatch):
    """MNLI and RACE through the JAX entry at dp 2, recording each step's
    loss: (jobs for two ranks: MNLI and RACE at dp 2, MNLI at tp 2 + SP;
    the JAX losses of each job)."""
    from megatron_llm_tpu import arguments as jax_args
    from megatron_llm_tpu.models.classification import (
        Classification as JaxClassification,
    )
    from megatron_llm_tpu.models.classification import (
        MultipleChoice as JaxMultipleChoice,
    )
    from megatron_llm_tpu_torch.tokenizer import build_tokenizer
    from test_torch_classification_tasks import (
        TASK_ARGV,
        _jax_tasks_main,
        _pretraining_checkpoints,
        write_mnli,
        write_race,
        write_vocab,
    )

    vocab = write_vocab(tmp_path)
    jdir, pdir, _ = _pretraining_checkpoints(
        tmp_path, build_tokenizer("BertWordPieceLowerCase",
                                  vocab_file=vocab).vocab_size)
    monkeypatch.setattr(jax_args, "args_to_configs",
                        _fp32(jax_args.args_to_configs))
    heads, jax_losses = {}, []
    inner_init = JaxClassification.init

    def jax_init(self, key):
        out = inner_init(self, key)
        heads["tree"] = jax.tree.map(np.asarray, out)
        return out

    monkeypatch.setattr(JaxClassification, "init", jax_init)
    for cls in (JaxClassification, JaxMultipleChoice):
        def recorded_loss(self, *a, _inner=cls.loss, **kw):
            loss = _inner(self, *a, **kw)
            jax.debug.callback(lambda v: jax_losses.append(float(v)), loss)
            return loss

        monkeypatch.setattr(cls, "loss", recorded_loss)
    base = TASK_ARGV.replace("--data_parallel_size 1", "").split() + [
        "--vocab_file", vocab, "--epochs", "1"]
    tasks = {"MNLI": ["--train_data", write_mnli(tmp_path / "t.tsv", 16, 5),
                      "--valid_data", write_mnli(tmp_path / "d.tsv", 8, 6)],
             "RACE": ["--train_data", write_race(tmp_path / "race", 8, 3),
                      "--valid_data", str(tmp_path / "race")]}
    jobs, want = [], []
    for task, data in tasks.items():
        argv = base + ["--task", task] + data
        jax_losses.clear()
        _jax_tasks_main().main(argv + ["--pretrained_checkpoint", jdir,
                                       "--data_parallel_size", "2"])
        jax.effects_barrier()
        jax_destroy()
        want.append(list(jax_losses))
        jobs.append((argv + ["--pretrained_checkpoint", pdir,
                             "--data_parallel_size", "2"],
                     heads["tree"]))
    # MNLI at tp 2 + SP too: the JAX loop's numbers, another layout
    want.append(want[0])
    jobs.append((jobs[0][0] + ["--tensor_model_parallel_size", "2",
                               "--sequence_parallel",
                               "--data_parallel_size", "1"],
                 jobs[0][1]))
    return jobs, want


def _retrieval_jobs(tmp_path, monkeypatch):
    """RET-FINETUNE-NQ (hard negatives) and RETRIEVER-EVAL through the
    JAX entry: (jobs for two ranks: RET-FINETUNE-NQ at dp 2 and at tp 2
    + SP, RETRIEVER-EVAL at dp 2; the JAX (loss, top-1) a step; the JAX
    DEV hit rates and top-k hits)."""
    from tasks.orqa import supervised as jax_sup
    from tasks.orqa.evaluate import ORQAEvaluator as JaxEvaluator
    from test_torch_orqa import (
        ARGV,
        FT_LR,
        _jax_tasks_main,
        checkpoints,
        fp32_configs,
        write_dpr,
        write_evidence,
        write_nq,
        write_vocab,
    )

    fp32_configs(monkeypatch)
    vocab = write_vocab(tmp_path)
    jdir, pdir = checkpoints(tmp_path, vocab)
    jax_losses, jax_evals = [], []
    inner_loss_fn = jax_sup.make_loss_fn

    def recorded_loss_fn(model, use_hard_negatives):
        inner = inner_loss_fn(model, use_hard_negatives)

        def loss_fn(params, batch, rng=None):
            loss, top1 = inner(params, batch, rng)
            jax.debug.callback(
                lambda a, b: jax_losses.append((float(a), float(b))),
                loss, top1)
            return loss, top1
        return loss_fn

    monkeypatch.setattr(jax_sup, "make_loss_fn", recorded_loss_fn)
    inner_eval = JaxEvaluator.evaluate

    def recorded_eval(self, *a, **kw):
        rates, stats = inner_eval(self, *a, **kw)
        jax_evals.append((rates, list(stats.top_k_hits)))
        return rates, stats

    monkeypatch.setattr(JaxEvaluator, "evaluate", recorded_eval)
    ft = ARGV.split() + ["--task", "RET-FINETUNE-NQ", "--vocab_file", vocab,
                         "--train_data", write_dpr(tmp_path), "--epochs",
                         "1", "--lr", str(FT_LR), "--use_hard_negatives",
                         "--pretrained_checkpoint"]
    _jax_tasks_main().main(ft + [jdir])
    jax.effects_barrier()
    evidence, docs = write_evidence(tmp_path)
    ev = ARGV.split() + ["--task", "RETRIEVER-EVAL", "--vocab_file", vocab,
                         "--evidence_data_path", evidence, "--qa_data_dev",
                         write_nq(tmp_path, docs, regex=False),
                         "--retriever_topk", "5", "--load"]
    _jax_tasks_main().main(ev + [jdir])
    jax_destroy()
    dp2 = ["--data_parallel_size", "2"]
    # the vocabulary padded to 64 x tp 2, the checkpoints' 128
    tp2 = ["--tensor_model_parallel_size", "2", "--sequence_parallel",
           "--data_parallel_size", "1", "--make_vocab_size_divisible_by",
           "64"]
    jobs = [(ft + [pdir] + dp2, None), (ft + [pdir] + tp2, None),
            (ev + [pdir] + dp2, None)]
    return jobs, jax_losses, jax_evals


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every JAX reference, then one 2-rank spawn (the tp 2, tp 2 + SP
    and dp 2 layouts, the finetuning and retrieval tasks) and one 4-rank
    spawn (tp 2 x dp 2 + SP + ZeRO-1, the three entries)."""
    with pytest.MonkeyPatch.context() as mp:
        trees, batches, jax_ws1, jax_mesh = _layout_refs()
        entry_jobs, jax_entries = _entry_jobs(
            tmp_path_factory.mktemp("entries"), mp)
    with pytest.MonkeyPatch.context() as mp:
        task_jobs, task_want = _task_jobs(tmp_path_factory.mktemp("tasks"),
                                          mp)
    with pytest.MonkeyPatch.context() as mp:
        ret_jobs, ret_losses, ret_evals = _retrieval_jobs(
            tmp_path_factory.mktemp("retrieval"), mp)
    two = spawn_cpu_group(2, ranks.suite, TWO, trees, batches, [],
                          task_jobs + ret_jobs, timeout_s=600)
    four = spawn_cpu_group(4, ranks.suite, FOUR, trees, batches,
                           entry_jobs, [], timeout_s=600)
    return {"jax": jax_ws1, "jax_mesh": jax_mesh,
            "ws1": _port_world1_steps(trees, batches),
            "two": [r["layouts"] for r in two],
            "four": [r["layouts"] for r in four],
            "entry_jobs": entry_jobs, "jax_entries": jax_entries,
            "entries": [r["entries"] for r in four],
            "task_want": task_want,
            "tasks": [r["tasks"][:len(task_jobs)] for r in two],
            "ret_losses": ret_losses, "ret_evals": ret_evals,
            "retrieval": [r["tasks"][len(task_jobs):] for r in two]}


def _grads_close(got, want, tol=1e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


CASES = [(n, c) for n, c in (("two", TWO), ("four", FOUR))
         for c in c]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("group,case", CASES,
                         ids=[c[0] for _, c in CASES])
def test_loss_gradients_and_shards_match_world_size_1(runs, group, case,
                                                      kind):
    out = [r[(case[0], kind)] for r in runs[group]]
    jl, jg = runs["jax"][kind]
    for r in out:
        assert r["bad_shards"] == [] and r["leaves"] > 10, r["bad_shards"]
        assert abs(r["loss"] - jl) <= 1e-5, (r["loss"], jl)
    _grads_close(_flat(out[0]["grads"]), jg)
    if group == "four":
        # the JAX package at the same layout on its virtual mesh
        ml, mg = runs["jax_mesh"][kind]
        assert abs(out[0]["loss"] - ml) <= 1e-5
        _grads_close(_flat(out[0]["grads"]), mg)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("group,case", CASES,
                         ids=[c[0] for _, c in CASES])
def test_one_adamw_step_matches_world_size_1(runs, group, case, kind):
    out = [r[(case[0], kind)] for r in runs[group]]
    loss, gnorm, stepped = runs["ws1"][kind]
    _, jg = runs["jax"][kind]
    for r in out:
        assert abs(r["step_loss"] - loss) <= 1e-5
        assert abs(r["grad_norm"] - gnorm) <= 1e-5 * max(1.0, gnorm)
    got = _flat(out[0]["stepped"])
    lr = ranks.STEP["lr"]
    for k, want in stepped.items():
        # Adam scales rounding noise (an exactly-zero gradient: the key
        # biases, an unread leaf) to about lr either way
        noise = np.abs(jg[k]) < 1e-6
        diff = np.abs(got[k] - want)
        assert diff[~noise].max(initial=0) <= 1e-5, k
        assert diff[noise].max(initial=0) <= 2 * lr + 1e-5, k


def test_ict_softmax_spans_the_global_batch_under_dp(runs):
    out = [r[("dp2", "ict")] for r in runs["two"]]
    jl = runs["jax"]["ict"][0]
    for r in out:
        assert abs(r["loss"] - jl) <= 1e-5
        # each rank's softmax over its own 2 contexts is another loss
        assert abs(r["rank_local_loss"] - jl) > 1e-2, (r, jl)
    four = [r[("tp2_dp2_sp_zero1", "ict")] for r in runs["four"]]
    assert all(abs(r["loss"] - jl) <= 1e-5 for r in four)


@pytest.mark.parametrize("module", ENTRIES)
def test_entry_at_tp2_dp2_matches_the_jax_entry(runs, module):
    i = ENTRIES.index(module)
    ref = runs["jax_entries"][module]
    for r, rank in enumerate(runs["entries"]):
        assert rank["jax_modules"] == []
        run = rank["runs"][i]
        assert run["layout"] == {"dp": 2, "tp": 2, "rank": r, "sp": True,
                                 "dp_rank": r // 2}
        assert run["iteration"] == 2 and run["consumed"] == 8
        assert [s[0] for s in run["steps"]] == [1, 2] \
            == [s[0] for s in ref]
        lo = (r // 2) * 2
        for (_, pl, _, pt, _), (_, jl, jt) in zip(run["steps"], ref):
            assert set(pt) == set(jt)
            for k in jt:
                # the rank's rows of the JAX global batch, bit for bit
                np.testing.assert_array_equal(pt[k], jt[k][:, lo:lo + 2],
                                              err_msg=k)
            assert abs(pl - jl) <= 1e-5, (pl, jl)
        # every rank reports the same global loss
        assert [s[1] for s in run["steps"]] == \
            [s[1] for s in runs["entries"][0]["runs"][i]["steps"]]
    if module == "pretrain_bert":
        # per-rank files: the model pieces of dp rank 0's two tp ranks,
        # the ZeRO-1 moments of every rank, every rank's marker
        files = runs["entries"][0]["runs"][i]["save_files"]
        assert files == {"model": ["rank00000.pt", "rank00001.pt"],
                         "optim": [f"rank{r:05d}.pt" for r in range(4)],
                         "done": [f"rank{r:05d}" for r in range(4)]}, files


@pytest.mark.parametrize("job", ["MNLI-dp2", "RACE-dp2", "MNLI-tp2-sp"])
def test_finetuning_tasks_across_ranks_match_the_jax_loop(runs, job):
    i = ["MNLI-dp2", "RACE-dp2", "MNLI-tp2-sp"].index(job)
    ref = runs["task_want"][i]
    got = [rank[i] for rank in runs["tasks"]]
    n = len(got[0]["losses"])
    assert n > 1 and len(ref) >= n, (len(ref), n)
    # a replicated scalar's callback may fire once a device
    ref = ref[::len(ref) // n]
    assert len(ref) == n, (len(ref), n)
    for rank in got:
        for s, (pl, jl) in enumerate(zip(rank["losses"], ref)):
            assert abs(pl - jl) <= 1e-5, (s, pl, jl)
    assert got[0]["final"] == got[1]["final"]


def test_retrieval_tasks_across_ranks_match_the_jax_entry(runs):
    assert len(runs["ret_losses"]) == 3  # 1 epoch x 3 batches of 4
    for rank in runs["retrieval"]:
        for rec in rank[:2]:  # RET-FINETUNE-NQ at dp 2, at tp 2 + SP
            assert len(rec["losses"]) == 3
            for (pl, pt), (jl, jt) in zip(rec["losses"],
                                          runs["ret_losses"]):
                assert abs(pl - jl) <= 1e-5 and abs(pt - jt) <= 1e-5
        # RETRIEVER-EVAL at dp 2: the evidence in per-rank store shards
        assert rank[2]["rates"]["DEV"] == runs["ret_evals"][0]


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,what,pp", [
    ("encoder", "encoder pretraining doesn't support cp",
     "encoder pretraining: pp>1 not supported (GPT-only pipeline)"),
    ("encoder-decoder", "encoder-decoder pretraining doesn't support cp",
     "encoder-decoder pretraining: pp>1 not supported"),
    ("encoder", "encoder finetuning tasks don't support cp",
     "encoder pretraining: pp>1 not supported (GPT-only pipeline)"),
])
def test_pp_and_cp_raise_with_the_jax_messages(family, what, pp):
    with pytest.raises(ValueError) as e:
        check_encoder_layout(ParallelConfig(pipeline_parallel_size=2),
                             family, what)
    assert str(e.value) == pp
    with pytest.raises(ValueError) as e:
        check_encoder_layout(ParallelConfig(context_parallel_size=2),
                             family, what)
    assert str(e.value) == ("--context_parallel_size: ring attention is "
                            "causal-only; " + what)


@pytest.mark.parametrize("flag", ["quantized_grad_reduce",
                                  "overlap_grad_reduce",
                                  "overlap_param_gather"])
def test_builder_refuses_the_explicit_zero1_flags(flag):
    model = ranks.port_model("bert")
    pcfg = ParallelConfig(data_parallel_size=2,
                          use_distributed_optimizer=True, **{flag: True})
    with pytest.raises(ValueError, match=f"{flag}.*batch_builder"):
        make_train_step(model, TrainConfig(), pcfg, batch_builder=dict)
