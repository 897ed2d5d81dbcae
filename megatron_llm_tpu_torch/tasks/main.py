"""Downstream-task entry point (port of tasks/main.py): classification
finetuning of the BERT encoder with a task head, an epoch loop with
validation accuracy after every epoch.

    python -m megatron_llm_tpu_torch.tasks.main --task MNLI \\
        --train_data train.tsv --valid_data dev_matched.tsv \\
        --pretrained_checkpoint ckpts/bert --tokenizer_type \\
        BertWordPieceLowerCase --vocab_file vocab.txt --num_layers 24 \\
        --hidden_size 1024 --num_attention_heads 16 --seq_length 512 \\
        --micro_batch_size 4 --epochs 3 --lr 5e-5 --bf16

(QQP and RACE likewise). The parser is the JAX entry's: the base flags
and `get_tasks_args`. It runs on the first CUDA card; `main(argv,
device="cpu")` runs on the CPU (the tests do). The encoder's weights
come from a BERT pretraining checkpoint (`--pretrained_checkpoint`, or
`--load`), the subtrees both trees hold merged in, the task head fresh
(JAX :127-158); without one the model starts from its random init.

The tasks of later slices raise by name: WIKITEXT103, LAMBADA and the
MSDP tasks (the zero-shot and MSDP tasks) and RETRIEVER-EVAL,
ICT-ZEROSHOT-NQ and RET-FINETUNE-NQ (the ICT/retrieval stack), both in
ROADMAP.md A6. So does the encoder at tp, SP or dp above 1.
"""

from __future__ import annotations

import dataclasses

import torch

LATER_TASKS = {
    "WIKITEXT103": "the zero-shot and MSDP tasks (ROADMAP.md A6)",
    "LAMBADA": "the zero-shot and MSDP tasks (ROADMAP.md A6)",
    "MSDP-PROMPT": "the zero-shot and MSDP tasks (ROADMAP.md A6)",
    "MSDP-EVAL-F1": "the zero-shot and MSDP tasks (ROADMAP.md A6)",
    "RETRIEVER-EVAL": "the ICT/biencoder/ORQA retrieval stack "
                      "(ROADMAP.md A6)",
    "ICT-ZEROSHOT-NQ": "the ICT/biencoder/ORQA retrieval stack "
                       "(ROADMAP.md A6)",
    "RET-FINETUNE-NQ": "the ICT/biencoder/ORQA retrieval stack "
                       "(ROADMAP.md A6)",
}


def get_tasks_args(parser):
    """The JAX entry's task options (JAX :29-74)."""
    g = parser.add_argument_group("tasks")
    g.add_argument("--task", type=str, required=True,
                   choices=["WIKITEXT103", "LAMBADA", "MNLI", "QQP", "RACE",
                            "MSDP-PROMPT", "MSDP-EVAL-F1",
                            "RETRIEVER-EVAL", "ICT-ZEROSHOT-NQ",
                            "RET-FINETUNE-NQ"])
    g.add_argument("--train_data", nargs="+", default=None)
    g.add_argument("--valid_data", nargs="*", default=None)
    g.add_argument("--overlapping_eval", type=int, default=32)
    g.add_argument("--strict_lambada", action="store_true")
    g.add_argument("--eval_micro_batch_size", type=int, default=None)
    g.add_argument("--epochs", type=int, default=3)
    g.add_argument("--pretrained_checkpoint", type=str, default=None)
    g.add_argument("--sample_input_file", type=str, default=None)
    g.add_argument("--sample_output_file", type=str, default=None)
    g.add_argument("--prompt_file", type=str, default=None)
    g.add_argument("--prompt_type", type=str, default=None,
                   choices=[None, "knowledge", "response"])
    g.add_argument("--num_prompt_examples", type=int, default=10)
    g.add_argument("--guess_file", type=str, default=None)
    g.add_argument("--answer_file", type=str, default=None)
    g.add_argument("--out_seq_length", type=int, default=100)
    g.add_argument("--qa_data_dev", type=str, default=None)
    g.add_argument("--qa_data_test", type=str, default=None)
    g.add_argument("--evidence_data_path", type=str, default=None)
    g.add_argument("--embedding_path", type=str, default=None)
    g.add_argument("--retriever_seq_length", type=int, default=256)
    g.add_argument("--retriever_topk", type=int, default=20)
    g.add_argument("--match", type=str, default="string",
                   choices=["string", "regex"])
    g.add_argument("--biencoder_shared_query_context_model",
                   action="store_true")
    g.add_argument("--biencoder_projection_dim", type=int, default=0)
    g.add_argument("--use_hard_negatives", action="store_true")
    return parser


def load_pretrained_encoder(path: str, mcfg, device) -> dict:
    """The parameter tree of the newest complete checkpoint in `path`, a
    BERT pretraining save with or without its binary head (the files
    say which), on `device`, weights only."""
    from megatron_llm_tpu_torch.models import BertModel
    from megatron_llm_tpu_torch.training.checkpointing import (
        load_checkpoint,
        open_leaves,
        tracked_checkpoint,
    )

    names = open_leaves(tracked_checkpoint(path)[0], "model").names()
    tmpl_cfg = dataclasses.replace(
        mcfg, add_binary_head="binary_head.w" in names)
    tmpl = BertModel(tmpl_cfg, device=device).abstract_params()
    restored = load_checkpoint(path, tmpl, None, None, finetune=True,
                               no_load_optim=True, device=device)
    if restored is None:
        raise FileNotFoundError(f"no loadable checkpoint in {path}")
    return restored[0]


def finetune_main(args, device, losses=None):
    """Classification finetuning (JAX :77-183); returns (params, best
    validation accuracy, final validation accuracy or None)."""
    from megatron_llm_tpu_torch.arguments import args_to_configs
    from megatron_llm_tpu_torch.models import Classification, MultipleChoice
    from megatron_llm_tpu_torch.pretrain_bert import check_single_card
    from megatron_llm_tpu_torch.tasks.finetune_utils import (
        accuracy,
        finetune,
    )
    from megatron_llm_tpu_torch.tokenizer import build_tokenizer

    tokenizer = build_tokenizer(
        args.tokenizer_type or "BertWordPieceLowerCase",
        vocab_file=args.vocab_file,
        make_vocab_size_divisible_by=args.make_vocab_size_divisible_by,
        tensor_parallel_size=args.tensor_model_parallel_size)
    args.model_name = "bert"
    mcfg, pcfg, tcfg, _ = args_to_configs(args, tokenizer.vocab_size)
    mcfg = dataclasses.replace(mcfg, add_binary_head=False)
    check_single_card(pcfg, f"{args.task} finetuning")
    if args.task == "MNLI":
        from megatron_llm_tpu_torch.tasks.glue.mnli import MNLIDataset as DS

        model = Classification(mcfg, num_classes=3, device=device)
    elif args.task == "QQP":
        from megatron_llm_tpu_torch.tasks.glue.qqp import QQPDataset as DS

        model = Classification(mcfg, num_classes=2, device=device)
    else:  # RACE
        from megatron_llm_tpu_torch.tasks.race.data import RaceDataset as DS

        model = MultipleChoice(mcfg, device=device)
    params = model.init(seed=tcfg.seed)
    # --load is the generic flag: an alias of --pretrained_checkpoint
    if not args.pretrained_checkpoint and args.load:
        args.pretrained_checkpoint = args.load
    if args.pretrained_checkpoint:
        # the encoder's subtrees from the pretraining checkpoint, the
        # task head fresh (the reference's strict=False load)
        loaded = load_pretrained_encoder(args.pretrained_checkpoint, mcfg,
                                         device)
        for key in params:
            if key in loaded:
                params[key] = loaded[key]
        print(" > loaded pretrained encoder weights "
              f"({sorted(set(params) & set(loaded))})", flush=True)
    if not args.train_data:
        raise SystemExit(f"--train_data is required for {args.task}")
    train_ds = DS("training", args.train_data, tokenizer, mcfg.seq_length)
    valid_ds = (DS("validation", args.valid_data, tokenizer,
                   mcfg.seq_length) if args.valid_data else None)
    params, best = finetune(
        model, params, train_ds, valid_ds, epochs=args.epochs,
        batch_size=args.micro_batch_size, lr=tcfg.lr,
        weight_decay=tcfg.weight_decay, seed=tcfg.seed,
        warmup_fraction=(args.lr_warmup_fraction
                         if args.lr_warmup_fraction is not None else 0.065),
        tcfg=tcfg, log_interval=args.log_interval, losses=losses)
    final = None
    if valid_ds is not None:
        final = accuracy(model, params, valid_ds, args.micro_batch_size)
        print(f"final validation accuracy: {final:.4f} (best {best:.4f})",
              flush=True)
    if args.save:
        from megatron_llm_tpu_torch.training.checkpointing import (
            save_checkpoint,
        )

        save_checkpoint(args.save, 0, params, None, mcfg)
        print(f"saved finetuned weights to {args.save}", flush=True)
    return params, best, final


def main(argv=None, device="cuda", losses=None):
    """Parse `argv` (sys.argv when None) and run the task; returns what
    `finetune_main` returns. `losses`, a list, receives each finetuning
    step's loss."""
    from megatron_llm_tpu_torch.arguments import build_base_parser

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tasks.main: no CUDA device (call "
                           "main(argv, device='cpu') to run on the CPU)")
    args = get_tasks_args(build_base_parser()).parse_args(argv)
    if args.task in LATER_TASKS:
        raise ValueError(f"--task {args.task} is not ported yet "
                         f"({LATER_TASKS[args.task]})")
    out = finetune_main(args, torch.device(device), losses)
    print("done :-)")
    return out


if __name__ == "__main__":
    main()
