"""PyTorch port, the classification heads and the downstream tasks
against the JAX package's, on the CPU in fp32 at tiny widths:

- `Classification` and `MultipleChoice`: logits within 1e-4, the loss
  and every gradient within 1e-5, on weights from the JAX `init`;
- the GLUE (MNLI, QQP) and RACE readers give the JAX readers' samples,
  field for field, through each package's WordPiece tokenizer;
- the two `tasks/main.py` parsers carry the same options; a bare
  `--task` of the zero-shot, MSDP and retrieval tasks is refused by both
  entries, naming the same flag; the encoder's multi-rank layouts are
  refused in one process without a process group;
- MNLI through `tasks.main` from the same pretraining checkpoint (the
  JAX save beside its `checkpoint_from_jax` copy) and the same heads:
  losses within 1e-5 step for step, the same validation accuracy; and
  RACE's run with every encoder leaf loaded bit for bit;
- the finetuning loop learns a linearly separable toy task (the port's
  twin of the JAX package's test_finetune_loop_learns_separable_task).
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu import arguments as jax_args
from megatron_llm_tpu.config import bert_config as jax_bert_config
from megatron_llm_tpu.models.classification import (
    Classification as JaxClassification,
)
from megatron_llm_tpu.models.classification import (
    MultipleChoice as JaxMultipleChoice,
)
from megatron_llm_tpu.models import BertModel as JaxBert
from megatron_llm_tpu.tokenizer import build_tokenizer as jax_tokenizer
from megatron_llm_tpu.training import checkpointing as jax_ckpt
from megatron_llm_tpu_torch import arguments
from megatron_llm_tpu_torch.config import bert_config
from megatron_llm_tpu_torch.convert.from_jax import (
    checkpoint_from_jax,
    params_from_jax,
)
from megatron_llm_tpu_torch.models import Classification, MultipleChoice
from megatron_llm_tpu_torch.optimizer.optimizer import tree_leaves, tree_map
from megatron_llm_tpu_torch.tasks import main as tasks_main
from megatron_llm_tpu_torch.tasks.finetune_utils import accuracy, finetune
from megatron_llm_tpu_torch.tasks.glue.mnli import MNLIDataset
from megatron_llm_tpu_torch.tasks.glue.qqp import QQPDataset
from megatron_llm_tpu_torch.tasks.race.data import RaceDataset
from megatron_llm_tpu_torch.tokenizer import build_tokenizer

from torch_parity import close, t

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            seq_length=32, vocab_size=100, ffn_hidden_size=128,
            hidden_dropout=0.0, attention_dropout=0.0,
            add_binary_head=False)


@pytest.fixture(autouse=True)
def _no_jax_context_left():
    yield
    from megatron_llm_tpu.parallel.mesh import destroy_parallel

    destroy_parallel()


def jitter(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32), tree)


def grads_close(jgrads, pp):
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(tree_leaves(pp))
    for path, g in flat:
        leaf = pp
        for k in path:
            leaf = leaf[k.key]
        close(leaf.grad, g, 1e-5, msg=jax.tree_util.keystr(path))


def inputs(seed, shape):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, 100, shape).astype(np.int32)
    keep = np.ones(shape, np.int32)
    keep[..., shape[-1] - rs.randint(1, 12):] = 0
    types = np.zeros(shape, np.int32)
    types[..., 12:] = 1
    return toks, keep, types


@pytest.mark.parametrize("head", ["classification", "multiple_choice"])
def test_heads_match_the_jax_heads(head):
    jc = jax_bert_config(compute_dtype=jnp.float32, **TINY)
    pc = bert_config(compute_dtype=torch.float32, **TINY)
    if head == "classification":
        jm, pm = JaxClassification(jc, 3), Classification(pc, 3, "cpu")
        shape, labels = (4, 32), np.array([0, 2, 1, 2], np.int32)
    else:
        jm, pm = JaxMultipleChoice(jc), MultipleChoice(pc, device="cpu")
        shape, labels = (3, 4, 32), np.array([3, 0, 2], np.int32)
    jp = jitter(jm.init(jax.random.key(1)), 1)
    pp = params_from_jax(jp, pc, device="cpu")
    assert set(pp) == set(jp)
    toks, keep, types = inputs(2, shape)
    jl = jm.forward(jp, jnp.asarray(toks), jnp.asarray(keep),
                    jnp.asarray(types))
    with torch.no_grad():
        pl = pm.forward(pp, t(toks), t(keep), t(types))
    assert tuple(pl.shape) == shape[:-1] + ((3,) if head ==
                                             "classification" else ())
    close(pl, jl, 1e-4)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(toks), jnp.asarray(labels), jnp.asarray(keep),
        jnp.asarray(types)))(jp)
    for leaf in tree_leaves(pp):
        leaf.requires_grad_(True)
    ploss = pm.loss(pp, t(toks), t(labels), t(keep), t(types))
    ploss.backward()
    assert abs(float(ploss.detach()) - float(jloss)) <= 1e-5
    grads_close(jgrads, pp)


def test_heads_init_the_jax_tree():
    """The same leaf names and shapes as the JAX heads' trees."""
    jc = jax_bert_config(compute_dtype=jnp.float32, **TINY)
    pc = bert_config(compute_dtype=torch.float32, **TINY)
    for jm, pm in ((JaxClassification(jc, 3), Classification(pc, 3, "cpu")),
                   (JaxMultipleChoice(jc), MultipleChoice(pc,
                                                          device="cpu"))):
        jshapes = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
                   jax.tree_util.tree_flatten_with_path(
                       jm.init(jax.random.key(0)))[0]}
        pshapes = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
                   jax.tree_util.tree_flatten_with_path(
                       pm.init(seed=0))[0]}
        assert pshapes == jshapes


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

WORDS = [f"w{i}" for i in range(60)]


def write_vocab(tmp_path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS + [
        f"##s{i}" for i in range(10)]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    return str(path)


def sentence(rs, n):
    return " ".join(rs.choice(WORDS, n)) + rs.choice(["", ".", " w1s3"])


MNLI_LABELS = ["entailment", "neutral", "contradiction"]


def write_mnli(path, n, seed):
    rs = np.random.RandomState(seed)
    rows = ["\t".join(["index"] + [f"c{i}" for i in range(7)]
                      + ["sentence1", "sentence2", "label1", "gold_label"])]
    for i in range(n):
        label = MNLI_LABELS[rs.randint(3)]
        rows.append("\t".join([str(i)] + ["-"] * 7 + [
            sentence(rs, rs.randint(3, 20)), sentence(rs, rs.randint(2, 15)),
            label, label]))
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def write_qqp(path, n, seed):
    rs = np.random.RandomState(seed)
    rows = ["id\tqid1\tqid2\tquestion1\tquestion2\tis_duplicate"]
    for i in range(n):
        rows.append(f"{i}\t{i}\t{i + 1}\t{sentence(rs, 6)}\t"
                    f"{sentence(rs, 5)}\t{rs.randint(2)}")
    rows.append("99\tmalformed row")
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def write_race(dirpath, n_files, seed):
    rs = np.random.RandomState(seed)
    os.makedirs(dirpath, exist_ok=True)
    for f in range(n_files):
        k = rs.randint(1, 4)
        with open(os.path.join(dirpath, f"{f}.txt"), "w") as fh:
            json.dump({"article": sentence(rs, rs.randint(10, 40)),
                       "questions": [sentence(rs, 4) for _ in range(k)],
                       "options": [[sentence(rs, 2) for _ in range(4)]
                                   for _ in range(k)],
                       "answers": [str("ABCD"[rs.randint(4)])
                                   for _ in range(k)]}, fh)
    return str(dirpath)


def test_readers_give_the_jax_samples(tmp_path):
    from tasks.glue.mnli import MNLIDataset as JaxMNLI
    from tasks.glue.qqp import QQPDataset as JaxQQP
    from tasks.race.data import RaceDataset as JaxRace

    vocab = write_vocab(tmp_path)
    ptok = build_tokenizer("BertWordPieceLowerCase", vocab_file=vocab)
    jtok = jax_tokenizer("BertWordPieceLowerCase", vocab_file=vocab)
    mnli = write_mnli(tmp_path / "mnli.tsv", 30, 0)
    qqp = write_qqp(tmp_path / "qqp.tsv", 20, 1)
    race = write_race(tmp_path / "race", 5, 2)
    for p, j in ((MNLIDataset("d", [mnli], ptok, 32),
                  JaxMNLI("d", [mnli], jtok, 32)),
                 (QQPDataset("d", [qqp], ptok, 24),
                  JaxQQP("d", [qqp], jtok, 24)),
                 (RaceDataset("d", [race], ptok, 40),
                  JaxRace("d", [race], jtok, 40))):
        assert len(p) == len(j) > 0
        for i in range(len(p)):
            ps, js = p[i], j[i]
            assert set(ps) == set(js)
            for k in js:
                np.testing.assert_array_equal(ps[k], js[k], err_msg=k)


# ---------------------------------------------------------------------------
# the entry
# ---------------------------------------------------------------------------


def _actions(parser):
    return {tuple(a.option_strings): (a.dest, a.default, a.nargs, a.const,
                                      tuple(a.choices or ()), a.type)
            for a in parser._actions if a.option_strings}


def _jax_tasks_main():
    from tasks import main as jax_tasks_main

    return jax_tasks_main


def test_tasks_parsers_carry_the_same_options():
    jm = _jax_tasks_main()
    j = _actions(jm.get_tasks_args(jax_args.build_base_parser()))
    p = _actions(tasks_main.get_tasks_args(arguments.build_base_parser()))
    assert set(j) == set(p)
    for opts in j:
        if opts[0] in ("--distributed_backend", "--chip_spec"):
            continue  # the port's own choices (tests/test_torch_finetune.py)
        assert j[opts] == p[opts], opts


@pytest.mark.parametrize("task,flag", [
    ("WIKITEXT103", "--valid_data"), ("LAMBADA", "--valid_data"),
    ("MSDP-PROMPT", "--sample_input_file"), ("MSDP-EVAL-F1", "--guess_file"),
    ("RETRIEVER-EVAL", "--evidence_data_path"),
    ("ICT-ZEROSHOT-NQ", "--evidence_data_path"),
    ("RET-FINETUNE-NQ", "--train_data"),
])
def test_later_tasks_raise_by_name(task, flag):
    """Every task of the JAX entry runs in the port: a bare `--task X` is
    refused where the JAX entry refuses it, naming the same missing
    flag."""
    with pytest.raises(AssertionError, match=flag):
        _jax_tasks_main().main(["--task", task])
    with pytest.raises(SystemExit, match=flag):
        tasks_main.main(["--task", task], device="cpu")


TASK_ARGV = ("--num_layers 2 --hidden_size 64 --num_attention_heads 4 "
             "--ffn_hidden_size 128 --seq_length 32 "
             "--max_position_embeddings 32 --micro_batch_size 4 "
             "--data_parallel_size 1 --epochs 2 --lr 1e-3 --log_interval 1 "
             "--hidden_dropout 0 --attention_dropout 0 --seed 11 "
             "--tokenizer_type BertWordPieceLowerCase "
             "--make_vocab_size_divisible_by 8")


@pytest.mark.parametrize("flags", [
    "--tensor_model_parallel_size 2", "--data_parallel_size 2",
    "--tensor_model_parallel_size 2 --sequence_parallel"])
def test_encoder_layouts_raise_by_name(tmp_path, flags):
    vocab = write_vocab(tmp_path)
    argv = (TASK_ARGV.replace("--data_parallel_size 1", "") + " " + flags
            + f" --task MNLI --vocab_file {vocab}").split()
    # these layouts run under torchrun (tests/test_torch_encoder_
    # parallel.py); one process without a process group refuses them
    with pytest.raises(RuntimeError, match="process group"):
        tasks_main.main(argv, device="cpu")


def _fp32(inner, dtype):
    def wrapped(args, vocab, *a, **kw):
        m, p, tc, d = inner(args, vocab, *a, **kw)
        return dataclasses.replace(m, compute_dtype=dtype), p, tc, d
    return wrapped


def _pretraining_checkpoints(tmp_path, vocab_size):
    """A JAX BERT pretraining save (with its binary head) and its port
    copy through `checkpoint_from_jax`: (jax dir, port dir, numpy tree)."""
    cfg = jax_bert_config(num_layers=2, hidden_size=64,
                          num_attention_heads=4, ffn_hidden_size=128,
                          seq_length=32, vocab_size=vocab_size,
                          make_vocab_size_divisible_by=8,
                          compute_dtype=jnp.float32)
    tree = jitter(JaxBert(cfg).init(jax.random.key(4)), 4)
    jdir, pdir = str(tmp_path / "jax_bert"), str(tmp_path / "port_bert")
    # made first: the JAX save writes meta.json there while orbax's
    # asynchronous save may not have made it yet (JAX
    # training/checkpointing.py:228-234)
    os.makedirs(jax_ckpt.checkpoint_dir(jdir, 2))
    jax_ckpt.save_checkpoint(jdir, 2, jax.tree.map(jnp.asarray, tree), None,
                             cfg)
    meta = {"iteration": 2, "config": {
        "kv_channels": cfg.kv_channels,
        "num_attention_heads": cfg.num_attention_heads,
        "num_attention_heads_kv": cfg.num_attention_heads_kv}}
    checkpoint_from_jax(tree, None, meta, pdir)
    return jdir, pdir, tree


def test_mnli_entry_matches_the_jax_entry(tmp_path, monkeypatch):
    from tasks import finetune_utils as jax_ft

    vocab = write_vocab(tmp_path)
    train = write_mnli(tmp_path / "train.tsv", 24, 5)
    valid = write_mnli(tmp_path / "dev.tsv", 12, 6)
    jdir, pdir, tree = _pretraining_checkpoints(
        tmp_path, build_tokenizer("BertWordPieceLowerCase",
                                  vocab_file=vocab).vocab_size)
    monkeypatch.setattr(jax_args, "args_to_configs",
                        _fp32(jax_args.args_to_configs, jnp.float32))
    monkeypatch.setattr(arguments, "args_to_configs",
                        _fp32(arguments.args_to_configs, torch.float32))

    # the same fresh heads: the port's init returns the JAX init's tree
    heads = {}
    inner_init = JaxClassification.init

    def jax_init(self, key):
        out = inner_init(self, key)
        heads["tree"] = jax.tree.map(np.asarray, out)
        return out

    monkeypatch.setattr(JaxClassification, "init", jax_init)
    monkeypatch.setattr(
        Classification, "init",
        lambda self, seed=0: params_from_jax(heads["tree"], self.cfg,
                                             device=self.device))

    jax_losses, jax_acc = [], []
    inner_loss = JaxClassification.loss

    def recorded_loss(self, *a, **kw):
        loss = inner_loss(self, *a, **kw)
        jax.debug.callback(lambda v: jax_losses.append(float(v)), loss)
        return loss

    monkeypatch.setattr(JaxClassification, "loss", recorded_loss)
    inner_acc = jax_ft.accuracy

    def recorded_acc(*a, **kw):
        acc = inner_acc(*a, **kw)
        jax_acc.append(acc)
        return acc

    monkeypatch.setattr(jax_ft, "accuracy", recorded_acc)
    argv = TASK_ARGV.split() + ["--task", "MNLI", "--vocab_file", vocab,
                                "--train_data", train, "--valid_data", valid]
    _jax_tasks_main().main(argv + ["--pretrained_checkpoint", jdir])
    port_losses = []
    params, best, final = tasks_main.main(
        argv + ["--pretrained_checkpoint", pdir], device="cpu",
        losses=port_losses)

    assert len(port_losses) == len(jax_losses) == 12  # 2 epochs x 6 steps
    for i, (pl, jl) in enumerate(zip(port_losses, jax_losses)):
        assert abs(pl - jl) <= 1e-5, (i, pl, jl)
    # per-epoch accuracies, then the final one
    assert len(jax_acc) == 3
    assert best == max(jax_acc[:2]) and final == jax_acc[2]
    assert len(set(round(x, 5) for x in port_losses)) > 3


def test_race_entry_loads_the_encoder_bit_for_bit(tmp_path, monkeypatch):
    vocab = write_vocab(tmp_path)
    race = write_race(tmp_path / "race", 6, 3)
    _, pdir, tree = _pretraining_checkpoints(
        tmp_path, build_tokenizer("BertWordPieceLowerCase",
                                  vocab_file=vocab).vocab_size)
    loaded = {}
    inner = tasks_main.load_pretrained_encoder

    def spy(*a, **kw):
        out = inner(*a, **kw)
        # as loaded: the finetuning then updates these tensors in place
        loaded.update(tree_map(lambda x: x.detach().clone(), out))
        return out

    monkeypatch.setattr(tasks_main, "load_pretrained_encoder", spy)
    argv = TASK_ARGV.split() + ["--task", "RACE", "--vocab_file", vocab,
                                "--train_data", race, "--valid_data", race,
                                "--epochs", "1",
                                "--pretrained_checkpoint", pdir]
    losses = []
    params, best, final = tasks_main.main(argv, device="cpu", losses=losses)
    assert set(loaded) == set(tree)  # the binary head's save, read whole
    for key in ("embedding", "layers", "final_norm", "pooler"):
        for path, a in jax.tree_util.tree_flatten_with_path(tree[key])[0]:
            leaf = loaded[key]
            for k in path:
                leaf = leaf[k.key]
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(a))
    assert "classification_head" in params and "lm_head" not in params
    assert losses and all(np.isfinite(losses)) and 0.0 <= final <= 1.0


class _Sep:
    """Label decided by the token after [CLS] (7 or 8): separable, so the
    loop (batching, masks, scheduler, optimizer) must reach ~1.0."""

    def __init__(self, n, seed):
        rs = np.random.RandomState(seed)
        self.samples = []
        for i in range(n):
            label = int(rs.rand() < 0.5)
            toks = rs.randint(10, 90, 30)
            toks[0] = 7 if label else 8
            ids = [2] + list(toks) + [3]
            self.samples.append({
                "text": np.array(ids[:32], np.int64),
                "types": np.zeros(32, np.int64),
                "padding_mask": np.ones(32, np.int64),
                "label": label, "uid": i})

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def test_finetune_loop_learns_separable_task():
    cfg = bert_config(num_layers=2, hidden_size=64, num_attention_heads=4,
                      seq_length=32, vocab_size=100, ffn_hidden_size=128,
                      compute_dtype=torch.float32, add_binary_head=False)
    model = Classification(cfg, num_classes=2, device="cpu")
    params = model.init(seed=2)
    train, valid = _Sep(256, 0), _Sep(64, 1)
    params, best = finetune(model, params, train, valid, epochs=4,
                            batch_size=16, lr=1e-3, log_interval=1000)
    acc = accuracy(model, params, valid, 16)
    assert acc > 0.95, acc
