"""PyTorch port, the zero-shot tasks against the JAX package's, on the
CPU in fp32 at tiny widths (2 layers, hidden 64), on token files made
from a seed:

- the detokenizers, rule for rule, on text with the PTB and WikiText
  artifacts;
- `EvalData` bit for bit through each package's NullTokenizer:
  WikiText windows with and without `--overlapping_eval`, LAMBADA cloze
  rows, strict and not, and a passage longer than the sequence;
- WIKITEXT103 and LAMBADA through `tasks.main` with `--load` of a
  converted JAX checkpoint (GPT and Llama): loss, ppl, adjusted ppl and
  token ratio within 1e-5, the correct counts equal, where half the
  cloze answers are the model's own greedy next token (so that the count
  is not 0).
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
from megatron_llm_tpu.tokenizer import build_tokenizer as jax_tokenizer
from megatron_llm_tpu.training import checkpointing as jax_ckpt
from megatron_llm_tpu_torch import arguments
from megatron_llm_tpu_torch.convert.from_jax import checkpoint_from_jax
from megatron_llm_tpu_torch.tasks import main as tasks_main
from megatron_llm_tpu_torch.tasks.zeroshot import datasets, detokenizer
from megatron_llm_tpu_torch.tokenizer import build_tokenizer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

VOCAB = 127  # NullTokenizer ids 0..126, eod 127
ARGV = ("--num_layers 2 --hidden_size 64 --num_attention_heads 4 "
        "--ffn_hidden_size 128 --seq_length 32 --max_position_embeddings 32 "
        "--micro_batch_size 3 --data_parallel_size 1 --hidden_dropout 0 "
        "--attention_dropout 0 --tokenizer_type NullTokenizer "
        f"--null_vocab_size {VOCAB} --seed 2")
# Llama (the 7B preset's 32 KV heads otherwise) with two query heads a
# KV group
GQA = {"gpt": [], "llama2": ["--num_attention_heads_kv", "2"]}


@pytest.fixture(autouse=True)
def _no_jax_context_left():
    """The JAX entry installs its parallel context for the process: drop
    it after each test."""
    yield
    from megatron_llm_tpu.parallel.mesh import destroy_parallel

    destroy_parallel()


def _jax_tasks_main():
    from tasks import main as jax_tasks_main

    return jax_tasks_main


def test_detokenizers_match_the_jax_rules():
    from tasks.zeroshot import detokenizer as jax_detok

    text = (" = = = Valkyria Chronicles = = = \n The game 's 2 @,@ 500 "
            "units ( with 3 @.@ 5 % ) were \" sold \" ; it 's n't $ 1 "
            "N # 1 [ a ] { b } ' c ' 9 " + chr(176) + " C , ok . yes ! "
            "no ? x : y \n ")
    for path in ("wiki.test.tokens", "ptb.valid.txt", "lambada.jsonl",
                 "other.txt"):
        assert detokenizer.get_detokenizer(path)(text) == \
            jax_detok.get_detokenizer(path)(text), path


def ints(rs, n, lo=0, hi=VOCAB):
    return " ".join(str(x) for x in rs.randint(lo, hi, n))


@pytest.mark.parametrize("task,kw", [
    ("WIKITEXT103", dict(overlapping_eval=None)),
    ("WIKITEXT103", dict(overlapping_eval=8)),
    ("WIKITEXT103", dict(overlapping_eval=32)),
    ("LAMBADA", dict(strict_lambada=False)),
    ("LAMBADA", dict(strict_lambada=True)),
])
def test_eval_data_equals_the_jax_arrays(tmp_path, task, kw):
    from tasks.zeroshot import datasets as jax_datasets

    rs = np.random.RandomState(7)
    if task == "WIKITEXT103":
        path = tmp_path / "wiki.test.tokens"
        path.write_text(ints(rs, 301))
    else:
        path = tmp_path / "lambada.jsonl"
        # the last passage outruns seq + 1: its context is cut on the left
        path.write_text("".join(json.dumps({"text": ints(rs, n)}) + "\n"
                                for n in (5, 12, 20, 33, 60)))
    seq = 32
    got = datasets.build_dataset(
        task, str(path), build_tokenizer("NullTokenizer",
                                         null_vocab_size=VOCAB), seq, **kw)
    want = jax_datasets.build_dataset(
        task, str(path), jax_tokenizer("NullTokenizer",
                                       null_vocab_size=VOCAB), seq, **kw)
    for name in ("tokens", "pad_mask"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert (got.num_original_tokens, got.num_tokenized_tokens) == (
        want.num_original_tokens, want.num_tokenized_tokens)
    assert len(got) > 1 and got.pad_mask.sum() > 0


def _fp32(inner, dtype):
    def wrapped(args, vocab, *a, **kw):
        m, p, tc, d = inner(args, vocab, *a, **kw)
        return dataclasses.replace(m, compute_dtype=dtype), p, tc, d
    return wrapped


def lm_checkpoints(tmp_path, model_name, seed=6):
    """The JAX entry's model of `ARGV --model_name` on jittered weights,
    saved by the JAX package and copied by `checkpoint_from_jax`: (jax
    model, jax params, jax dir, port dir)."""
    from finetune import model_provider as jax_model_provider

    argv = ARGV.split() + ["--model_name", model_name] + GQA[model_name]
    args = jax_args.build_base_parser().parse_args(argv)
    tok = jax_tokenizer("NullTokenizer", null_vocab_size=VOCAB)
    mcfg = dataclasses.replace(
        jax_args.args_to_configs(args, tok.vocab_size)[0],
        compute_dtype=jnp.float32)
    model = jax_model_provider(args, mcfg)
    rs = np.random.RandomState(seed)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + 0.02 * rs.standard_normal(a.shape))
        .astype(np.float32), model.init(jax.random.key(seed)))
    jdir, pdir = str(tmp_path / "jax_lm"), str(tmp_path / "port_lm")
    # made first: the JAX save writes meta.json there while orbax's
    # asynchronous save may not have made it yet
    os.makedirs(jax_ckpt.checkpoint_dir(jdir, 1))
    params = jax.tree.map(jnp.asarray, tree)
    jax_ckpt.save_checkpoint(jdir, 1, params, None, mcfg)
    checkpoint_from_jax(tree, None, {"iteration": 1, "config": {
        "kv_channels": mcfg.kv_channels,
        "num_attention_heads": mcfg.num_attention_heads,
        "num_attention_heads_kv": mcfg.num_attention_heads_kv}}, pdir)
    return model, params, jdir, pdir


def write_lambada(path, model, params, rs, n=10):
    """Cloze passages: the even ones end in the model's greedy next
    token after their context, the odd ones in a random id."""
    lines = []
    for i in range(n):
        ctx = [int(x) for x in rs.randint(0, VOCAB, rs.randint(5, 25))]
        if i % 2 == 0:
            logits, _ = model.forward(params, jnp.asarray([ctx], jnp.int32))
            answer = int(jnp.argmax(logits[0, -1]))
        else:
            answer = int(rs.randint(VOCAB))
        lines.append(json.dumps({"text": " ".join(map(str, ctx + [answer]))}))
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("task,model_name,flags", [
    ("WIKITEXT103", "gpt", "--overlapping_eval 8"),
    ("WIKITEXT103", "llama2", ""),
    ("LAMBADA", "gpt", ""),
    ("LAMBADA", "llama2", "--strict_lambada --eval_micro_batch_size 4"),
])
def test_zeroshot_entry_matches_the_jax_entry(tmp_path, monkeypatch, task,
                                              model_name, flags):
    from tasks.zeroshot import evaluate as jax_eval

    model, params, jdir, pdir = lm_checkpoints(tmp_path, model_name)
    rs = np.random.RandomState(8)
    if task == "WIKITEXT103":
        data = tmp_path / "wiki.test.tokens"
        data.write_text(ints(rs, 200))
    else:
        data = tmp_path / "lambada.jsonl"
        write_lambada(data, model, params, rs)
    monkeypatch.setattr(jax_args, "args_to_configs",
                        _fp32(jax_args.args_to_configs, jnp.float32))
    monkeypatch.setattr(arguments, "args_to_configs",
                        _fp32(arguments.args_to_configs, torch.float32))
    jax_out = []
    inner = jax_eval.evaluate_and_print_results
    monkeypatch.setattr(jax_eval, "evaluate_and_print_results",
                        lambda *a, **kw: jax_out.append(inner(*a, **kw))
                        or jax_out[-1])
    argv = ARGV.split() + GQA[model_name] + flags.split() + [
        "--task", task, "--model_name", model_name, "--valid_data",
        str(data)]
    _jax_tasks_main().main(argv + ["--load", jdir])
    got = tasks_main.main(argv + ["--load", pdir], device="cpu")
    (want,) = jax_out
    assert set(got) == set(want)
    if task == "WIKITEXT103":
        for k in ("avg_loss", "ppl", "adjusted_ppl", "token_ratio"):
            assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), k
        assert 3.0 < got["avg_loss"] < 10.0
    else:
        assert got["num_correct"] == want["num_correct"]
        assert got["num_examples"] == want["num_examples"] == 10
        assert got["accuracy"] == want["accuracy"]
        if "--strict_lambada" not in flags:
            # the greedy-answer half is right, the random half not
            assert 5 <= got["num_correct"] < 10
