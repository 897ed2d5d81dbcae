"""PyTorch port, the MSDP tasks against the JAX package's, on the CPU, on
Wizard-of-Wikipedia, prompt and reference files made from a seed:

- the F1 metrics: `normalize_answer`, `f1_score` and `f1_score_all`
  equal on seeded strings with articles and punctuation;
- the preprocessing: every output file of `process_wow_dataset`, the
  knowledge prompt selection (seen and unseen topics), the response
  prompt selection and the knowledge merge equal byte for byte, and
  `get_database`'s tables equal;
- MSDP-EVAL-F1 through `tasks.main`: the JAX entry's precision, recall
  and F1;
- MSDP-PROMPT through `tasks.main` with `--load` of a converted JAX GPT
  checkpoint (fp32, 2 layers, hidden 64) on a byte-level BPE vocabulary,
  knowledge and response prompts: the output files equal byte for byte
  (greedy streams).
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
from megatron_llm_tpu.training import checkpointing as jax_ckpt
from megatron_llm_tpu_torch import arguments
from megatron_llm_tpu_torch.convert.from_jax import checkpoint_from_jax
from megatron_llm_tpu_torch.tasks import main as tasks_main
from megatron_llm_tpu_torch.tasks.msdp import metrics, preprocessing

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TOPICS = ["Cats", "Dogs", "Jazz", "Rivers"]
WORDS = ["the", "a", "an", "cat", "dog", "plays", "music", "river", "flows",
         "is", "small", "loud", "quiet", "and", "likes", "water", "jazz",
         "it", "this", "long", "(old)", "sea"]


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


def sentence(rs, lo=3, hi=9, end=True):
    words = list(rs.choice(WORDS, rs.randint(lo, hi)))
    out = " ".join(words)
    if end:
        out += rs.choice(["", ".", "?", "!", ", ok"])
    return out


def test_f1_metrics_match_the_jax_metrics():
    from tasks.msdp import metrics as jax_metrics

    rs = np.random.RandomState(0)
    guesses = [sentence(rs, 0, 8) for _ in range(40)]
    answers = [sentence(rs, 0, 8) if i % 7 else "" for i in range(40)]
    for g, a in zip(guesses, answers):
        assert metrics.normalize_answer(g) == jax_metrics.normalize_answer(g)
        assert metrics.f1_score(g, a) == jax_metrics.f1_score(g, a)
    got = metrics.f1_score_all(guesses, answers)
    assert got == jax_metrics.f1_score_all(guesses, answers)
    assert 0 < got[2] < 1


def write_wow(path, rs, n_dialogs=12):
    """Wizard-of-Wikipedia dialogs: apprentice and wizard turns, the
    wizard's checked sentence and passage present, absent or several."""
    data = []
    for _ in range(n_dialogs):
        topic = str(rs.choice(TOPICS))
        dialog = []
        for j in range(rs.randint(2, 7)):
            turn = {"speaker": "0_Apprentice" if j % 2 == 0 else "1_Wizard",
                    "text": sentence(rs)}
            if j % 2:
                pick = rs.randint(4)
                turn["checked_sentence"] = (
                    {} if pick == 0 else
                    {"k": f"{topic} {sentence(rs, 2, 25, end=False)}"})
                turn["checked_passage"] = (
                    {} if pick < 2 else {"p": topic} if pick == 2 else
                    {"p": topic, "q": "x"})
            dialog.append(turn)
        data.append({"chosen_topic": topic, "dialog": dialog})
    path.write_text(json.dumps(data))


def _preprocess(pkg, raw, out):
    """Run every preprocessing step of `pkg` into `out`; returns
    get_database's tables."""
    os.makedirs(out)
    j = lambda name: os.path.join(out, name)  # noqa: E731
    pkg.process_wow_dataset(raw, j("train.txt"), j("knwl.txt"),
                            j("resp.txt"))
    pkg.process_wow_dataset(raw.replace("train", "test"), j("test.txt"))
    pkg.prompt_selection_for_knowledge_generation(
        j("test.txt"), j("train.txt"), j("knwl_prompts.jsonl"), "wow_seen",
        topk=3)
    pkg.prompt_selection_for_knowledge_generation(
        j("test.txt"), j("train.txt"), j("knwl_prompts_unseen.jsonl"),
        "wow_unseen", topk=2)
    pkg.prompt_selection_for_response_generation(
        j("train.txt"), j("resp_prompts.txt"), seed=3, num_prompts=5)
    with open(j("test.txt")) as f:
        n = sum(1 for _ in f)
    with open(j("gen_knwl.txt"), "w") as f:
        f.write("".join(f"knowledge {i}<|endoftext|>\n" for i in range(n)))
    pkg.prepare_input_for_response_generation(
        j("test.txt"), j("gen_knwl.txt"), j("merged.txt"))
    return pkg.get_database(j("test.txt"), j("train.txt"), "wow_unseen")


def test_preprocessing_matches_the_jax_files(tmp_path):
    from tasks.msdp import preprocessing as jax_pre

    write_wow(tmp_path / "wow_train.json", np.random.RandomState(1))
    write_wow(tmp_path / "wow_test.json", np.random.RandomState(2), 5)
    raw = str(tmp_path / "wow_train.json")
    want = _preprocess(jax_pre, raw, str(tmp_path / "jax"))
    got = _preprocess(preprocessing, raw, str(tmp_path / "port"))
    assert got == want
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 9
    for name in names:
        a = (tmp_path / "port" / name).read_bytes()
        assert a == (tmp_path / "jax" / name).read_bytes(), name
        assert a, name
    knwl = (tmp_path / "port" / "knwl.txt").read_text().splitlines()
    assert "no_passages_used" in knwl and len(set(knwl)) > 2


def test_msdp_eval_f1_matches_the_jax_entry(tmp_path, monkeypatch):
    from tasks.msdp import evaluate as jax_msdp_eval

    rs = np.random.RandomState(4)
    guess, answer = tmp_path / "guess.txt", tmp_path / "answer.txt"
    guess.write_text("".join(sentence(rs) + rs.choice(["", "<|endoftext|>"])
                             + "\n" for _ in range(20)))
    answer.write_text("".join(
        (sentence(rs) if i % 5 else "no_passages_used") + "\n"
        for i in range(20)))
    want = []
    inner = jax_msdp_eval.evaluate_f1
    monkeypatch.setattr(jax_msdp_eval, "evaluate_f1",
                        lambda *a: want.append(inner(*a)) or want[-1])
    argv = ["--task", "MSDP-EVAL-F1", "--guess_file", str(guess),
            "--answer_file", str(answer)]
    _jax_tasks_main().main(argv)
    got = tasks_main.main(argv, device="cpu")
    assert got == want[0] and 0 < got[2] < 1


def bytes_bpe(tmp_path):
    """A byte-level GPT-2 BPE vocabulary (the 256 bytes and
    <|endoftext|>, no merges)."""
    from megatron_llm_tpu_torch.tokenizer.gpt2_bpe import bytes_to_unicode

    vocab = {ch: b for b, ch in bytes_to_unicode().items()}
    vocab["<|endoftext|>"] = 256
    vf, mf = tmp_path / "vocab.json", tmp_path / "merges.txt"
    vf.write_text(json.dumps(vocab))
    mf.write_text("#version: fixture\n")
    return str(vf), str(mf)


ARGV = ("--model_name gpt --num_layers 2 --hidden_size 64 "
        "--num_attention_heads 4 --ffn_hidden_size 128 --seq_length 512 "
        "--max_position_embeddings 512 --micro_batch_size 1 "
        "--data_parallel_size 1 --tokenizer_type GPT2BPETokenizer "
        "--out_seq_length 12 --num_prompt_examples 2 --seed 1")


def _fp32(inner, dtype):
    def wrapped(args, vocab, *a, **kw):
        m, p, tc, d = inner(args, vocab, *a, **kw)
        return dataclasses.replace(m, compute_dtype=dtype), p, tc, d
    return wrapped


def gpt_checkpoints(tmp_path, argv, seed=5):
    """The JAX entry's GPT on jittered weights, saved by the JAX package
    and copied by `checkpoint_from_jax`: (jax dir, port dir)."""
    from finetune import model_provider as jax_model_provider
    from megatron_llm_tpu.tokenizer import build_tokenizer as jax_tokenizer

    args = jax_args.build_base_parser().parse_known_args(argv)[0]
    tok = jax_tokenizer("GPT2BPETokenizer", vocab_file=args.vocab_file,
                        merges_file=args.merges_file)
    mcfg = jax_args.args_to_configs(args, tok.vocab_size)[0]
    rs = np.random.RandomState(seed)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32),
        jax_model_provider(args, mcfg).init(jax.random.key(seed)))
    jdir, pdir = str(tmp_path / "jax_gpt"), str(tmp_path / "port_gpt")
    # made first: the JAX save writes meta.json there while orbax's
    # asynchronous save may not have made it yet
    os.makedirs(jax_ckpt.checkpoint_dir(jdir, 1))
    jax_ckpt.save_checkpoint(jdir, 1, jax.tree.map(jnp.asarray, tree), None,
                             mcfg)
    checkpoint_from_jax(tree, None, {"iteration": 1, "config": {
        "kv_channels": mcfg.kv_channels,
        "num_attention_heads": mcfg.num_attention_heads,
        "num_attention_heads_kv": mcfg.num_attention_heads_kv}}, pdir)
    return jdir, pdir


@pytest.mark.parametrize("prompt_type", ["knowledge", "response"])
def test_msdp_prompt_matches_the_jax_entry(tmp_path, monkeypatch,
                                           prompt_type):
    rs = np.random.RandomState(6)
    vf, mf = bytes_bpe(tmp_path)
    test = tmp_path / "test.txt"
    rows = [(str(rs.choice(TOPICS)), sentence(rs), sentence(rs))
            for _ in range(3)]
    test.write_text("".join(f"{t}\thi [SEP] {u}\t{t} {k}\tyes.\n"
                            for t, u, k in rows))
    prompts = tmp_path / "prompts"
    if prompt_type == "knowledge":
        prompts.write_text("".join(json.dumps(
            {f"{t} {u}": [f"( {sentence(rs)} ) {t} => {t} {sentence(rs)}"
                          for _ in range(2)]}) + "\n"
            for t, u, _ in rows[:2]))
    else:
        prompts.write_text("".join(
            f"Topic: {t}. User says: {sentence(rs)} We know that: "
            f"{sentence(rs)} System replies: {sentence(rs)}\n"
            for t in TOPICS))
    argv = ARGV.split() + ["--vocab_file", vf, "--merges_file", mf,
                           "--task", "MSDP-PROMPT", "--sample_input_file",
                           str(test), "--prompt_file", str(prompts),
                           "--prompt_type", prompt_type]
    monkeypatch.setattr(jax_args, "args_to_configs",
                        _fp32(jax_args.args_to_configs, jnp.float32))
    monkeypatch.setattr(arguments, "args_to_configs",
                        _fp32(arguments.args_to_configs, torch.float32))
    jdir, pdir = gpt_checkpoints(tmp_path, argv)
    jout, pout = tmp_path / "jax_out.txt", tmp_path / "port_out.txt"
    _jax_tasks_main().main(argv + ["--load", jdir, "--sample_output_file",
                                   str(jout)])
    got = tasks_main.main(argv + ["--load", pdir, "--sample_output_file",
                                  str(pout)], device="cpu")
    assert got == str(pout)
    lines = pout.read_text().splitlines()
    assert len(lines) == 3 and any(lines)
    assert pout.read_bytes() == jout.read_bytes()
