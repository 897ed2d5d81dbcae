"""Multi-stage dialogue prompting, MSDP-PROMPT (port of
tasks/msdp/prompt.py): few-shot prompt a GPT-family model to generate
the grounding knowledge for the last user turn (stage 1, "knowledge")
or the system's response given that knowledge (stage 2, "response"),
reading preprocessing.py's files:

- test file: `topic \\t context [SEP]-joined \\t knowledge \\t response`;
- knowledge prompts: jsonl {topic + " " + last_turn: [instances]};
- response prompts: plain lines, the first --num_prompt_examples used.

Each input is generated greedily (`top_k_sampling=1`) through the
whole-batch API, `inference/api.generate_and_post_process` (on a card
its decode attention is K1), and the first line of the completion is
kept.

Across ranks every rank of a tp (or pp, or cp) group calls the API with
the same request, on the installed layout's own groups (the SPMD route
of inference/api.py). At dp > 1 sample i goes to dp group i mod dp;
global rank 0 gathers the completions and writes the file in the input
file's order, the file of world size 1.
"""

from __future__ import annotations

import json

import torch.distributed as dist

from megatron_llm_tpu_torch.parallel.mesh import get_context
from megatron_llm_tpu_torch.tasks.msdp.preprocessing import word_tokenize


def read_prompts(prompt_path, prompt_type, n_example):
    """ref: prompt.py:38-71."""
    if prompt_type == "knowledge":
        prompt_examples_dict = {}
        with open(prompt_path) as f:
            for line in f:
                line_dict = json.loads(line.strip())
                key = list(line_dict.keys())[0]
                if key not in prompt_examples_dict:
                    prompt = ""
                    for instance in line_dict[key]:
                        prompt += instance.strip() + " \n"
                    prompt_examples_dict[key] = prompt
        return prompt_examples_dict
    prompt = ""
    with open(prompt_path) as f:
        for instance in f.readlines()[:n_example]:
            prompt += instance.strip() + " \n"
    return prompt


def build_input(test_sample: str, prompt_type: str, prompts):
    """One test line -> the full few-shot input string
    (ref: prompt.py:95-130 / 215-260)."""
    splits = test_sample.strip().split("\t")
    topic = splits[0]
    turns = splits[1].split(" [SEP] ")
    last_turn = turns[-1]
    if prompt_type == "knowledge":
        key = topic + " " + last_turn
        inputs = prompts.get(key, "") if isinstance(prompts, dict) \
            else prompts
        inputs += "( " + last_turn + " ) " + topic + " =>"
        return inputs
    knowledge = splits[2]
    last_turn = " ".join(word_tokenize(last_turn)).strip()
    knowledge = " ".join(word_tokenize(knowledge)).strip()
    inputs = prompts
    inputs += (f"Topic: {topic}. User says: {last_turn} We know that: "
               f"{knowledge} System replies:")
    return inputs


def generate_samples_from_file(
    model, params, tokenizer, sample_input_file, sample_output_file,
    prompt_file, prompt_type, num_prompt_examples: int = 10,
    out_seq_length: int = 100,
):
    """Prompt the model over every test line (ref: prompt.py:154-290).
    Greedy (top_k=1) like the reference's api mode; one line of the
    completion is kept."""
    from megatron_llm_tpu_torch.inference.api import (
        generate_and_post_process,
    )

    assert prompt_type in ("knowledge", "response")
    prompts = read_prompts(prompt_file, prompt_type, num_prompt_examples)

    with open(sample_input_file) as f:
        test_samples = [ln for ln in f.read().splitlines() if ln.strip()]

    ctx = get_context()
    if ctx is not None and ctx.world_size == 1:
        ctx = None
    dp, dp_rank = (1, 0) if ctx is None else (ctx.dp, ctx.dp_rank)
    mine = {}
    for i in range(dp_rank, len(test_samples), dp):
        inputs = build_input(test_samples[i], prompt_type, prompts)
        texts, _, _, _ = generate_and_post_process(
            model, params, tokenizer, [inputs],
            tokens_to_generate=out_seq_length, top_k_sampling=1,
        )
        completion = texts[0][len(inputs):]
        completion = completion.split("\n")[0].strip()
        mine[i] = completion.replace("<|endoftext|>", "")
    if ctx is not None:
        parts = [None] * ctx.world_size if ctx.rank == 0 else None
        dist.gather_object(mine, parts, dst=0)
        if ctx.rank != 0:
            return sample_output_file
        mine = {i: c for part in parts for i, c in part.items()}
    with open(sample_output_file, "w") as fout:
        for i in range(len(test_samples)):
            fout.write(mine[i] + "\n")
    return sample_output_file


def main(args, model=None, params=None, tokenizer=None):
    """Dispatch target of tasks.main --task MSDP-PROMPT."""
    return generate_samples_from_file(
        model, params, tokenizer,
        args.sample_input_file, args.sample_output_file,
        args.prompt_file, args.prompt_type,
        num_prompt_examples=args.num_prompt_examples,
        out_seq_length=args.out_seq_length,
    )
