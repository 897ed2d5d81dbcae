"""PyTorch port, the GPT-family tasks of `tasks.main` across ranks against
the JAX entry at the same layout on its virtual CPU mesh, in fp32 at tiny
widths (a Llama of 2 layers, hidden 64, 4 heads in 2 KV groups):

- WIKITEXT103 (seq 16, NullTokenizer, `--use_flash_attn`, from `--load`
  of a converted checkpoint, each rank reading its slices): avg loss,
  ppl and adjusted ppl within 1e-5 relative;
- LAMBADA (seq 16, NullTokenizer, from the init): the correct counts
  equal, where some cloze answers are the model's greedy token and some
  are a column of the output layer tied bit for bit with one on the
  other tp rank (the lowest index wins, as `jnp.argmax`'s rule);
- MSDP-PROMPT, knowledge and response (seq 256, a byte-level BPE, from
  `--load`): the output file equal line for line;

at dp 2, tp 2, tp 2 + SP, pp 2 and cp 2 (one 2-rank spawn running the
layouts one after another) and tp 2 x dp 2 + SP (one 4-rank spawn), the
two spawns running while the JAX entry runs in this process. The
sample counts are no multiple of the batch of 3, and 3 rows split over
dp 2 pad a row, so the zero-mask padding rows are exercised. The JAX
entry runs every one of these layouts (none raises), so no layout is
refused by the port either. Every rank returns the same metrics; only
rank 0 prints the result lines; no rank imports JAX.
"""

import concurrent.futures
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_lm_task_ranks as ranks
from megatron_llm_tpu import arguments as jax_args
from megatron_llm_tpu.parallel.mesh import destroy_parallel as jax_destroy
from megatron_llm_tpu_torch.convert.from_jax import checkpoint_from_jax
from megatron_llm_tpu_torch.utils.virtual_mesh import spawn_cpu_group

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

VOCAB = 127  # NullTokenizer ids 0..126, eod 127: 128 entries, no padding
TIE = (5, 69)  # output columns on tp rank 0 and tp rank 1 of 2
MODEL = ("--model_name llama2 --num_layers 2 --hidden_size 64 "
         "--num_attention_heads 4 --num_attention_heads_kv 2 "
         "--ffn_hidden_size 128 --micro_batch_size 3 --hidden_dropout 0 "
         "--attention_dropout 0 --seed 2 --log_interval 1")
ZS = (MODEL + " --seq_length 16 --max_position_embeddings 16 "
      f"--tokenizer_type NullTokenizer --null_vocab_size {VOCAB}")
MSDP = (MODEL + " --seq_length 256 --max_position_embeddings 256 "
        "--tokenizer_type GPT2BPETokenizer --out_seq_length 6 "
        "--num_prompt_examples 1")
# name: (ranks, tp, flags); the vocabulary padded to the same size at
# every tp (make_vocab_size_divisible_by x tp)
LAYOUTS = {
    "dp2": (2, 1, "--data_parallel_size 2"),
    "tp2": (2, 2, "--data_parallel_size 1 --tensor_model_parallel_size 2"),
    "tp2_sp": (2, 2, "--data_parallel_size 1 --tensor_model_parallel_size 2 "
                     "--sequence_parallel"),
    "pp2": (2, 1, "--data_parallel_size 1 --pipeline_model_parallel_size 2"),
    "cp2": (2, 1, "--data_parallel_size 1 --context_parallel_size 2"),
    "tp2_dp2_sp": (4, 2, "--data_parallel_size 2 "
                         "--tensor_model_parallel_size 2 --sequence_parallel"),
}
WS1 = (1, 1, "--data_parallel_size 1")
JOBS = ("WIKITEXT103", "LAMBADA", "knowledge", "response")


def _jax_model(argv, vocab):
    from finetune import model_provider as jax_model_provider

    args = jax_args.build_base_parser().parse_known_args(argv)[0]
    mcfg = dataclasses.replace(jax_args.args_to_configs(args, vocab)[0],
                               compute_dtype=jnp.float32)
    return jax_model_provider(args, mcfg)


def _tree(model, seed, scale):
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rs.standard_normal(a.shape))
        .astype(np.float32), jax.jit(model.init)(jax.random.key(seed)))


def _zeroshot_tree():
    """The zero-shot Llama's tree: output columns TIE the same large
    vector, so that wherever it points along the hidden state the two
    columns tie for the argmax, bit for bit."""
    model = _jax_model(ZS.split() + ["--make_vocab_size_divisible_by",
                                     "64"], VOCAB + 1)
    tree = _tree(model, 6, 0.02)
    head = tree["lm_head"]
    assert head.shape == (64, 128)
    u = np.random.RandomState(9).standard_normal(64).astype(np.float32)
    head[:, TIE[0]] = head[:, TIE[1]] = 4.0 * u
    return model, tree


def _ints(rs, n):
    return " ".join(str(x) for x in rs.randint(0, VOCAB, n))


def _zeroshot_data(d, model, tree):
    """(wiki path, lambada path, the greedy answers' ties): 11 cloze
    passages, a third answered by the model's greedy token, a third by
    column TIE[0], a third at random."""
    rs = np.random.RandomState(8)
    wiki = d / "wiki.test.tokens"
    wiki.write_text(_ints(rs, 150))
    params = jax.tree.map(jnp.asarray, tree)
    # one compiled forward over the evaluation's 16 positions: the causal
    # logits at the context's last position do not read the pads after it
    forward = jax.jit(lambda p, x: model.forward(p, x)[0])
    lines, ties = [], 0
    for i in range(11):
        ctx = [int(x) for x in rs.randint(0, VOCAB, rs.randint(4, 15))]
        logits = forward(params, jnp.asarray([ctx + [0] * (16 - len(ctx))],
                                             jnp.int32))
        last = np.asarray(logits[0, len(ctx) - 1])
        answer = (int(np.argmax(last)), TIE[0],
                  int(rs.randint(VOCAB)))[i % 3]
        if i % 3 == 1 and last[TIE[0]] == last.max():
            assert last[TIE[1]] == last[TIE[0]]  # an exact tie
            ties += 1
        lines.append(json.dumps({"text": " ".join(map(str, ctx + [answer]))}))
    lam = d / "lambada.jsonl"
    lam.write_text("\n".join(lines) + "\n")
    return str(wiki), str(lam), ties


def _bytes_bpe(d):
    from test_torch_msdp import bytes_bpe

    return bytes_bpe(d)


def _msdp_data(d):
    """(test file, knowledge prompts, response prompts): 3 short
    dialogues (dp 2 deals them 2 and 1), so every input fits the 256
    positions."""
    from test_torch_msdp import TOPICS, sentence

    rs = np.random.RandomState(6)
    rows = [(str(rs.choice(TOPICS)), sentence(rs, 2, 4), sentence(rs, 2, 4))
            for _ in range(3)]
    test = d / "test.txt"
    test.write_text("".join(f"{t}\thi [SEP] {u}\t{t} {k}\tyes.\n"
                            for t, u, k in rows))
    knwl = d / "knwl_prompts.jsonl"
    knwl.write_text("".join(json.dumps(
        {f"{t} {u}": [f"( {sentence(rs, 2, 3)} ) {t} => "
                      f"{sentence(rs, 2, 3)}"]})
        + "\n" for t, u, _ in rows[:2]))
    resp = d / "resp_prompts.txt"
    resp.write_text("".join(
        f"Topic: {t}. User says: {sentence(rs, 2, 3)} We know that: "
        f"{sentence(rs, 2, 3)} System replies: {sentence(rs, 2, 3)}\n"
        for t in TOPICS[:2]))
    return str(test), str(knwl), str(resp)


def _port_checkpoint(tree, model, d):
    c = model.cfg
    checkpoint_from_jax(tree, None, {"iteration": 1, "config": {
        "kv_channels": c.kv_channels,
        "num_attention_heads": c.num_attention_heads,
        "num_attention_heads_kv": c.num_attention_heads_kv}}, str(d))
    return str(d)


def _argvs(layout, paths, out_dir):
    """{job: argv} of one layout (or "ws1"), shared by both packages,
    the MSDP output file under `out_dir`."""
    _, tp, flags = LAYOUTS.get(layout, WS1)
    wiki, lam, test, knwl, resp, vf, mf = paths
    zs = ZS.split() + flags.split() + [
        "--make_vocab_size_divisible_by", str(64 // tp)]
    ms = MSDP.split() + flags.split() + [
        "--make_vocab_size_divisible_by", str(128 // tp),
        "--vocab_file", vf, "--merges_file", mf, "--task", "MSDP-PROMPT",
        "--sample_input_file", test]
    return {
        "WIKITEXT103": zs + ["--task", "WIKITEXT103", "--valid_data", wiki,
                             "--use_flash_attn"],
        "LAMBADA": zs + ["--task", "LAMBADA", "--valid_data", lam],
        "knowledge": ms + ["--prompt_file", knwl, "--prompt_type",
                           "knowledge", "--sample_output_file",
                           str(out_dir / f"{layout}_knowledge.txt")],
        "response": ms + ["--prompt_file", resp, "--prompt_type", "response",
                          "--sample_output_file",
                          str(out_dir / f"{layout}_response.txt")],
    }


def _jax_runs(paths, trees, tmp):
    """The JAX entry at every layout (and at world size 1), its models'
    init patched to the shared trees: {(layout, job): metrics dict or
    the output file's text}."""
    from tasks import main as jax_tasks_main
    from tasks.zeroshot import evaluate as jax_eval

    from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama

    out, got = {}, []
    inner_eval = jax_eval.evaluate_and_print_results
    with pytest.MonkeyPatch.context() as mp:
        inner_cfg = jax_args.args_to_configs

        def fp32(*a, **kw):
            m, p, t, d = inner_cfg(*a, **kw)
            return dataclasses.replace(m, compute_dtype=jnp.float32), p, \
                t, d

        mp.setattr(jax_args, "args_to_configs", fp32)
        mp.setattr(jax_eval, "evaluate_and_print_results",
                   lambda *a, **kw: got.append(inner_eval(*a, **kw))
                   or got[-1])
        which = {}
        mp.setattr(JaxLlama, "init", lambda self, key: jax.tree.map(
            jnp.asarray, trees[which["tree"]]))
        for layout in ["ws1"] + list(LAYOUTS):
            for job, argv in _argvs(layout, paths, tmp / "jax").items():
                which["tree"] = "zs" if job in JOBS[:2] else "msdp"
                got.clear()
                try:
                    jax_tasks_main.main(argv)
                finally:
                    jax_destroy()
                out[(layout, job)] = got[0] if got else open(
                    argv[argv.index("--sample_output_file") + 1]).read()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_tasks")
    (d / "jax").mkdir()
    (d / "port").mkdir()
    zs_model, zs_tree = _zeroshot_tree()
    wiki, lam, ties = _zeroshot_data(d, zs_model, zs_tree)
    vf, mf = _bytes_bpe(d)
    test, knwl, resp = _msdp_data(d)
    ms_model = _jax_model(MSDP.split() + [
        "--make_vocab_size_divisible_by", "128"], 257)
    ms_tree = _tree(ms_model, 5, 0.3)
    paths = (wiki, lam, test, knwl, resp, vf, mf)
    zs_dir = _port_checkpoint(zs_tree, zs_model, d / "zs_ck")
    ms_dir = _port_checkpoint(ms_tree, ms_model, d / "ms_ck")

    def jobs(layouts):
        out = []
        for layout in layouts:
            for job, argv in _argvs(layout, paths, d / "port").items():
                if job == "LAMBADA":  # from the init, the tree handed over
                    out.append(((layout, job), argv, zs_tree))
                else:  # from --load, each rank reading its slices
                    out.append(((layout, job), argv + [
                        "--load", zs_dir if job == "WIKITEXT103"
                        else ms_dir], None))
        return out

    two = [k for k, v in LAYOUTS.items() if v[0] == 2]
    four = [k for k, v in LAYOUTS.items() if v[0] == 4]
    # the two port groups (subprocesses) run while this process runs the
    # JAX entry
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        groups = [(n, pool.submit(spawn_cpu_group, n, ranks.run_jobs,
                                  jobs(names), timeout_s=600))
                  for n, names in ((2, two), (4, four))]
        jax_out = _jax_runs(paths, {"zs": zs_tree, "msdp": ms_tree}, d)
        port = {}
        for n, group in groups:
            for r, rank in enumerate(group.result()):
                for rec in rank:
                    port.setdefault(rec["name"], [None] * n)[r] = rec
    return {"jax": jax_out, "port": port, "ties": ties}


CASES = [(layout, job) for layout in LAYOUTS for job in JOBS]


@pytest.mark.parametrize("layout,job", CASES,
                         ids=[f"{a}-{b}" for a, b in CASES])
def test_lm_task_across_ranks_matches_the_jax_entry(runs, layout, job):
    want = runs["jax"][(layout, job)]
    # the JAX entry's answer does not depend on its layout
    ws1 = runs["jax"][("ws1", job)]
    recs = runs["port"][(layout, job)]
    for r, rec in enumerate(recs):
        assert rec["jax_modules"] == []
        got = rec["result"]
        if job == "WIKITEXT103":
            for k in ("avg_loss", "ppl", "adjusted_ppl", "token_ratio"):
                assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k
                assert abs(want[k] - ws1[k]) <= 1e-5 * abs(ws1[k]), k
            assert 3.0 < got["avg_loss"] < 10.0
        elif job == "LAMBADA":
            assert got == want == ws1
        else:
            assert got.endswith(f"{layout}_{job}.txt")
        # every rank the same metrics; rank 0 alone prints
        assert got == recs[0]["result"]
        printed = rec["printed"]
        if job in ("WIKITEXT103", "LAMBADA"):
            assert (f"validation results on {job}" in printed) == (r == 0)
            assert ("> working on iteration" in printed) == (r == 0)
    if job in ("knowledge", "response"):
        with open(recs[0]["result"]) as f:
            text = f.read()
        lines = text.split("\n")[:-1]  # random bytes: no splitlines
        assert text == want == ws1
        # three samples, line for line, not all alike
        assert len(lines) == 3 and len(set(lines)) > 1, lines


def test_the_data_exercise_padding_and_the_tie(runs):
    """The zero-shot sets are no whole number of batches of 3; some cloze
    answers are the tied column, the lowest index of the tie, and count
    as correct; some are right, some wrong."""
    wiki = runs["jax"][("ws1", "WIKITEXT103")]
    lam = runs["jax"][("ws1", "LAMBADA")]
    assert lam["num_examples"] == 11
    assert runs["ties"] >= 1
    assert runs["ties"] <= lam["num_correct"] < 11
    assert wiki["token_ratio"] == 1.0
    for rank in runs["port"][("tp2", "LAMBADA")]:
        assert rank["result"]["num_correct"] == lam["num_correct"]
