"""PyTorch port, the fine-tuning entry point across ranks.

`finetune.main` runs in four gloo CPU processes
(utils/virtual_mesh.spawn_cpu_group) at tp 2 x dp 2 with sequence
parallelism and ZeRO-1, the recipe's parallel flags, on a tiny Llama
(fp32) from a seeded corpus:

- its step losses equal, within 1e-5, the JAX package's `finetune.main`
  at the same layout on its virtual CPU mesh and the port's at world
  size 1 on the same global batches;
- each dp rank loads exactly its rows of every global microbatch (JAX
  `data_axis_span`);
- a tp2 x dp2 checkpoint resumes at world size 1, and a world-size-1
  checkpoint at tp2 x dp2, each giving the uninterrupted run's next
  losses;
- a rank imports no JAX;
- pipeline and context parallelism and the overlap schedulers raise,
  naming the next A4 PR.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from megatron_llm_tpu import arguments as jax_args
from megatron_llm_tpu.data import indexed_dataset as jax_idx
from megatron_llm_tpu.models import LlamaModel as JaxLlama
from megatron_llm_tpu.parallel.multihost import data_axis_span
from megatron_llm_tpu.training.trainer import Trainer as JaxTrainer
from megatron_llm_tpu_torch import arguments
from megatron_llm_tpu_torch.utils.virtual_mesh import spawn_cpu_group

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = ("--model_name llama2 --num_layers 2 --hidden_size 64 "
        "--num_attention_heads 4 --num_attention_heads_kv 2 "
        "--ffn_hidden_size 128 --seq_length 32 --micro_batch_size 1 "
        "--global_batch_size 4 --lr 1e-3 --lr_decay_style cosine "
        "--lr_warmup_iters 1 --tokenizer_type NullTokenizer "
        "--null_vocab_size 255 --split 98,2,0 --eval_interval 0 "
        "--eval_iters 1 --log_interval 1 --recompute_granularity full "
        "--seed 3 --train_iters 5").split()
PARALLEL = ["--tensor_model_parallel_size", "2", "--data_parallel_size", "2",
            "--sequence_parallel", "--use_distributed_optimizer"]
FIRST = ["--save_interval", "3", "--exit_interval", "3"]


def _corpus(path, name, seed, n_docs=200, vocab=255):
    rs = np.random.RandomState(seed)
    prefix = os.path.join(path, name)
    b = jax_idx.MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    for _ in range(n_docs):
        b.add_item(np.append(rs.randint(0, vocab, rs.randint(4, 60)), vocab))
        b.end_document()
    b.finalize(prefix + ".idx")
    return prefix


def _jax_finetune():
    spec = importlib.util.spec_from_file_location(
        "jax_finetune_entry", os.path.join(REPO, "finetune.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_finetune")
    a, b = _corpus(str(tmp), "A", 0), _corpus(str(tmp), "B", 1)
    base = TINY + ["--data_path", "0.7", a, "0.3", b]
    par_ck, one_ck = str(tmp / "par_ck"), str(tmp / "one_ck")
    jft = _jax_finetune()
    inner = jft.args_to_configs

    def fp32(args, vocab):
        m, p, t, d = inner(args, vocab)
        return dataclasses.replace(m, compute_dtype=jnp.float32), p, t, d

    # every run starts from the JAX package's initial weights
    mcfg = fp32(jax_args.build_base_parser().parse_args(base), 256)[0]
    init = jax.tree.map(np.asarray, JaxLlama(mcfg).init(jax.random.key(0)))
    # world size 1, in this process: the whole run, then the first three
    # steps saved for the tp2 x dp2 resume
    one = torch_ranks.finetune_runs([base, base + FIRST + ["--save",
                                                          one_ck]], init)
    ranks = spawn_cpu_group(
        4, torch_ranks.finetune_runs,
        [base + PARALLEL + FIRST + ["--save", par_ck],
         base + PARALLEL + ["--load", one_ck]], init, timeout_s=300)
    resumed = torch_ranks.finetune_runs([base + ["--load", par_ck]], init)
    # the JAX package at tp2 x dp2 (devices 0-3 of its virtual mesh)
    jft.args_to_configs = fp32
    jax_log, step, jinit = [], JaxTrainer.train_step, JaxLlama.init
    JaxLlama.init = lambda self, rng: jax.tree.map(jnp.asarray, init)

    def record(self, state, text, *a, **kw):
        stats = step(self, state, text, *a, **kw)
        jax_log.append((state.iteration, float(stats["loss"])))
        return stats

    JaxTrainer.train_step = record
    try:
        jft.main(base + PARALLEL + ["--exit_interval", "3"])
    finally:
        JaxTrainer.train_step = step
        JaxLlama.init = jinit
        jft.args_to_configs = inner
    return {"one": one, "ranks": ranks, "resumed": resumed, "jax": jax_log}


def _losses(run):
    return [(it, loss) for it, loss, *_ in run["steps"]]


def test_losses_match_world_size_1_and_jax(runs):
    whole = _losses(runs["one"]["runs"][0])
    assert [it for it, _ in whole] == [1, 2, 3, 4, 5]
    for rank in runs["ranks"]:
        first = _losses(rank["runs"][0])
        assert [it for it, _ in first] == [1, 2, 3]
        for (_, got), (_, want) in zip(first, whole):
            assert abs(got - want) <= 1e-5, (got, want)
    assert [it for it, _ in runs["jax"]] == [1, 2, 3]
    for (_, got), (_, want) in zip(_losses(runs["ranks"][0]["runs"][0]),
                                   runs["jax"]):
        assert abs(got - want) <= 1e-5, (got, want)
    # the losses moved: three real steps
    assert len({round(l, 6) for _, l in whole[:3]}) == 3


def test_grad_norms_match_world_size_1(runs):
    whole = runs["one"]["runs"][0]["steps"]
    for rank in runs["ranks"]:
        for got, want in zip(rank["runs"][0]["steps"], whole):
            assert abs(got[2] - want[2]) <= 1e-5 * want[2], (got, want)


def test_each_dp_rank_loads_its_rows(runs):
    whole = runs["one"]["runs"][0]["steps"]
    for r, rank in enumerate(runs["ranks"]):
        dp_index = r // 2  # tp is the fastest axis
        for got, want in zip(rank["runs"][0]["steps"], whole):
            # world size 1 reads the global batch as 4 microbatches of
            # 1 row; dp 2 as 2 global microbatches of 2 rows, one a rank
            glob = want[3].reshape(2, 2, -1)
            lo, hi = data_axis_span([dp_index], glob.shape[1], 2)
            assert got[4] == (lo, hi)
            np.testing.assert_array_equal(got[3], glob[:, lo:hi])
    assert runs["ranks"][0]["runs"][0]["consumed"] == 12


@pytest.mark.parametrize("direction", ["tp2dp2_to_1", "1_to_tp2dp2"])
def test_checkpoints_resume_across_layouts(runs, direction):
    whole = _losses(runs["one"]["runs"][0])
    if direction == "tp2dp2_to_1":
        got = [_losses(runs["resumed"]["runs"][0])]
    else:
        got = [_losses(rank["runs"][1]) for rank in runs["ranks"]]
    for run in got:
        assert [it for it, _ in run] == [4, 5]
        for (it, loss), (wit, want) in zip(run, whole[3:]):
            assert it == wit and abs(loss - want) <= 1e-5, (it, loss, want)


def test_ranks_import_no_jax(runs):
    for rank in runs["ranks"]:
        assert rank["jax_modules"] == []
    assert len({rank["pid"] for rank in runs["ranks"]}) == 4


@pytest.mark.parametrize("flags", [
    "--pipeline_model_parallel_size 2 --context_parallel_size 2",
    "--context_parallel_size 2",
    "--overlap_grad_reduce",
    "--overlap_param_gather",
    "--async_pipeline_dispatch",
    "--pipeline_model_parallel_size 2 --async_pipeline_dispatch",
])
def test_later_parallel_flags_raise_naming_the_next_a4_pr(flags):
    args = arguments.build_base_parser().parse_args(
        TINY + ["--use_distributed_optimizer"] + flags.split())
    with pytest.raises(ValueError, match="next A4 PR"):
        arguments.args_to_configs(args, 256)


def test_two_ranks_on_one_card_refuse_nccl(monkeypatch):
    """NCCL cannot put two ranks on one device: the port says so, naming
    the backend, before a process group is made."""
    from megatron_llm_tpu_torch.parallel import mesh

    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="nccl.*gloo"):
        mesh.check_backend("nccl", torch.device("cuda", 0))
    mesh.check_backend("gloo", torch.device("cuda", 0))
