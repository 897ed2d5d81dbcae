"""Wizard-of-Wikipedia preprocessing for multi-stage dialogue prompting
(port of tasks/msdp/preprocessing.py):

- `process_wow_dataset`: WoW dialog json -> the 4-column test format
  `topic \\t context [SEP]-joined \\t knowledge \\t response` and the
  knowledge and response reference files;
- `get_database`: the per-topic prompt-instance database of a processed
  train file;
- `prompt_selection_for_knowledge_generation`: for each test sample,
  the top-k most similar training instances of its topic, as the jsonl
  prompt dict keyed `topic + " " + last_turn`; similarity is normalised
  token-F1 overlap, or embedding dot products through an `encode_fn`;
- `prompt_selection_for_response_generation`: a seeded random selection
  of response-generation prompt lines;
- `prepare_input_for_response_generation`: the generated knowledge
  merged back into the test file.

Words are split by nltk's word_tokenize where it imports and runs, by a
regex otherwise, as in the JAX package.
"""

from __future__ import annotations

import json
import re

import numpy as np

from megatron_llm_tpu_torch.tasks.msdp.metrics import (
    f1_score,
    normalize_answer,
)


def word_tokenize(text: str):
    try:
        from nltk import word_tokenize as nltk_tok

        return nltk_tok(text)
    except Exception:
        return re.findall(r"\w+|[^\w\s]", text)


def process_wow_dataset(raw_file, processed_file, knwl_ref_file=None,
                        resp_ref_file=None):
    """ref: preprocessing.py:42-127."""
    with open(raw_file) as fr:
        dialog_data = json.load(fr)

    fproc = open(processed_file, "w")
    fknwl = open(knwl_ref_file, "w") if knwl_ref_file else None
    fresp = open(resp_ref_file, "w") if resp_ref_file else None
    try:
        for sample in dialog_data:
            turn_list = []
            for j, turn in enumerate(sample["dialog"]):
                text = turn["text"]
                if not text.endswith(("?", ".", "!")):
                    text = text + "."
                if j == 0:
                    turn_list.append(text)
                    continue
                speaker = turn["speaker"].lower()
                if "wizard" in speaker:
                    checked_sentence = list(
                        turn.get("checked_sentence", {}).values())
                    checked_passage = list(
                        turn.get("checked_passage", {}).values())
                    assert len(checked_sentence) <= 1
                    knowledge = (checked_sentence[0] if checked_sentence
                                 else "no_passages_used")
                    passage = (checked_passage[0]
                               if len(checked_passage) == 1
                               else "no_passages_used")
                    topic = (passage if passage != "no_passages_used"
                             else sample["chosen_topic"])
                    dialog_context = " [SEP] ".join(turn_list)
                    response = text
                    turn_list.append(response)
                    fproc.write(f"{topic}\t{dialog_context}\t{knowledge}"
                                f"\t{response}\n")
                    if fknwl:
                        fknwl.write(knowledge + "\n")
                    if fresp:
                        fresp.write(
                            " ".join(word_tokenize(response)) + "\n")
                else:
                    assert "apprentice" in speaker
                    turn_list.append(text)
    finally:
        fproc.close()
        if fknwl:
            fknwl.close()
        if fresp:
            fresp.close()


def get_database(test_datapath, train_datapath, data_type="wow_seen"):
    """ref: preprocessing.py:243-320 — per-topic instance/dialog lists."""
    assert data_type in ("wow_seen", "wow_unseen", "woi")
    test_topics = set()
    with open(test_datapath) as f:
        for line in f:
            test_topics.add(line.strip().split("\t")[0])

    train_data_by_topic: dict = {}
    dialog_data_by_topic: dict = {}
    dialog_examples = []
    with open(train_datapath) as f:
        for line in f:
            splits = line.strip().split("\t")
            topic = splits[0]
            turns = splits[1].split(" [SEP] ")[-3:]
            knowledge = splits[2]
            if knowledge == "no_passages_used":
                continue
            if data_type != "wow_seen" and ("(" in knowledge
                                            or ")" in knowledge):
                continue
            if data_type != "wow_seen" and topic not in knowledge:
                continue
            last_turn = turns[-1]
            instance = f"( {last_turn} ) {topic} => {knowledge}"
            dialog_example = ""
            if data_type != "wow_seen":
                dialog_example += f"( {topic} ) "
            dialog_example += " ".join(turns)

            if topic in test_topics:
                train_data_by_topic.setdefault(topic, []).append(instance)
                dialog_data_by_topic.setdefault(topic, []).append(
                    dialog_example)
            else:
                if len(knowledge.split()) > 20:
                    continue
                if knowledge.lower().startswith(("it", "this")):
                    continue
            dialog_examples.append((topic, dialog_example, instance))
    return train_data_by_topic, dialog_data_by_topic, dialog_examples


def _lexical_similarity(query: str, candidates):
    """Token-F1 overlap ranking (the no-checkpoint default; the reference
    ranks with a DPR encoder, ref :323-362)."""
    qn = normalize_answer(query)
    scores = []
    for cand in candidates:
        _, _, f1 = f1_score(qn, cand)
        scores.append(f1 if f1 is not None else 0.0)
    return np.asarray(scores)


def prompt_selection_for_knowledge_generation(
    test_datapath, train_datapath, output_prompt_path,
    data_type="wow_seen", topk: int = 10, encode_fn=None,
):
    """Per test sample: top-k most relevant training instances of the same
    topic, written as jsonl {key: [prompt instances]} with key =
    `topic + " " + last_turn` (ref :364-460). `encode_fn(texts)->(n,d)`
    switches ranking to embedding dot products (the reference's DPR
    form); default is lexical overlap."""
    train_by_topic, dialog_by_topic, _ = get_database(
        test_datapath, train_datapath, data_type
    )

    with open(test_datapath) as f, open(output_prompt_path, "w") as fout:
        seen = set()
        for line in f:
            splits = line.strip().split("\t")
            topic = splits[0]
            last_turn = splits[1].split(" [SEP] ")[-1]
            key = topic + " " + last_turn
            if key in seen:
                continue
            seen.add(key)
            instances = train_by_topic.get(topic, [])
            dialogs = dialog_by_topic.get(topic, [])
            if not instances:
                fout.write(json.dumps({key: []}) + "\n")
                continue
            query = (f"( {topic} ) " if data_type != "wow_seen" else "") \
                + last_turn
            if encode_fn is not None:
                qv = np.asarray(encode_fn([query]))[0]
                dv = np.asarray(encode_fn(dialogs))
                scores = dv @ qv
            else:
                scores = _lexical_similarity(query, dialogs)
            order = np.argsort(-scores)[:topk]
            # most-similar LAST (the reference appends nearest at the end,
            # closest to the test input)
            chosen = [instances[i] for i in order[::-1]]
            fout.write(json.dumps({key: chosen}) + "\n")


def prompt_selection_for_response_generation(input_path, output_path,
                                             seed: int = 1234,
                                             num_prompts: int = 20):
    """Seeded random selection of response-generation prompt lines in the
    `Topic: .. User says: .. We know that: .. System replies: ..` form
    (ref :462-531)."""
    rows = []
    with open(input_path) as f:
        for line in f:
            splits = line.strip().split("\t")
            topic, context, knowledge, response = (
                splits[0], splits[1], splits[2], splits[3])
            if knowledge == "no_passages_used":
                continue
            last_turn = " ".join(word_tokenize(
                context.split(" [SEP] ")[-1]))
            knowledge = " ".join(word_tokenize(knowledge))
            response = " ".join(word_tokenize(response))
            rows.append(
                f"Topic: {topic}. User says: {last_turn} We know that: "
                f"{knowledge} System replies: {response}"
            )
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(rows))[:num_prompts]
    with open(output_path, "w") as f:
        for i in idx:
            f.write(rows[int(i)] + "\n")


def prepare_input_for_response_generation(test_file, knwl_gen_file,
                                          processed_file):
    """Merge generated knowledge into the test file (ref :533-559)."""
    with open(knwl_gen_file) as f:
        knowledge_list = f.readlines()
    with open(test_file) as fr, open(processed_file, "w") as fw:
        for line_num, line in enumerate(fr):
            splits = line.strip().split("\t")
            topic, dialog_context, response = (splits[0], splits[1],
                                               splits[3])
            knowledge = knowledge_list[line_num].strip().replace(
                "<|endoftext|>", "")
            fw.write(f"{topic}\t{dialog_context}\t{knowledge}"
                     f"\t{response}\n")
