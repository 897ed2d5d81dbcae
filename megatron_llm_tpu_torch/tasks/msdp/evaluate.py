"""MSDP F1 over guess and answer files, MSDP-EVAL-F1 (port of
tasks/msdp/evaluate.py): one guess and one gold answer a line;
`<|endoftext|>` stripped from the guesses, the gold placeholder
`no_passages_used` an empty answer (left out of the average)."""

from __future__ import annotations

from megatron_llm_tpu_torch.tasks.msdp.metrics import f1_score_all


def evaluate_f1(guess_file: str, answer_file: str):
    """Returns (precision, recall, f1) (ref: evaluate.py:12-38)."""
    guesses = []
    with open(guess_file) as f:
        for line in f:
            line = line.strip().replace("<|endoftext|>", "")
            guesses.append(line)

    answers = []
    with open(answer_file) as f:
        for line in f:
            line = line.strip()
            if line == "no_passages_used":
                line = ""
            answers.append(line)

    precision, recall, f1 = f1_score_all(guesses, answers)
    print(f"Precision: {precision:.4f}; recall: {recall:.4f}; "
          f"f1: {f1:.4f}", flush=True)
    return precision, recall, f1


def main(args):
    return evaluate_f1(args.guess_file, args.answer_file)
