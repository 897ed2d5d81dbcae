"""Downstream-task entry point (port of tasks/main.py), the JAX entry's
ten tasks:

- MNLI, QQP and RACE: classification finetuning of the BERT encoder
  with a task head, an epoch loop with validation accuracy after every
  epoch;
- WIKITEXT103 and LAMBADA: zero-shot perplexity and cloze accuracy of
  a GPT-family model (`--model_name`), its forward unmasked, so flash
  attention (K4) under `--use_flash_attn`;
- MSDP-PROMPT: greedy knowledge or response generation through the
  whole-batch API (its decode attention K1); MSDP-EVAL-F1: F1 of a
  guess file against an answer file, no model;
- RETRIEVER-EVAL and ICT-ZEROSHOT-NQ: a biencoder's top-k retrieval
  accuracy on NQ over an evidence TSV, embedded on the fly or read from
  a prebuilt store (`--embedding_path`,
  tools/build_retrieval_index.py); RET-FINETUNE-NQ: supervised
  biencoder finetuning on DPR-format json.

    python -m megatron_llm_tpu_torch.tasks.main --task MNLI \\
        --train_data train.tsv --valid_data dev_matched.tsv \\
        --pretrained_checkpoint ckpts/bert --tokenizer_type \\
        BertWordPieceLowerCase --vocab_file vocab.txt --num_layers 24 \\
        --hidden_size 1024 --num_attention_heads 16 --seq_length 512 \\
        --micro_batch_size 4 --epochs 3 --lr 5e-5 --bf16

    python -m megatron_llm_tpu_torch.tasks.main --task WIKITEXT103 \\
        --valid_data wiki.test.tokens --model_name llama2 --load ckpt \\
        --tokenizer_type GPT2BPETokenizer --vocab_file vocab.json \\
        --merges_file merges.txt --use_flash_attn --bf16

The parser is the JAX entry's: the base flags and `get_tasks_args`. It
runs on the first CUDA card; `main(argv, device="cpu")` runs on the CPU
(the tests do). Under torchrun the encoder tasks (MNLI, QQP, RACE and
the retrieval tasks) run at tensor, sequence and data parallelism, as
the JAX entry's `initialize_parallel(dp, pp=1, tp, ...)` does, one
process per rank: the finetuning batch is the global batch, each rank
computing its batch / dp rows (tasks/finetune_utils.py,
tasks/orqa/supervised.py), and RETRIEVER-EVAL and ICT-ZEROSHOT-NQ embed
each rank's share of the evidence into the store's per-rank shards and
merge them; for them pipeline and context parallelism are refused with
the JAX entry's message. WIKITEXT103, LAMBADA and MSDP-PROMPT run at
every layout the JAX entry's `initialize_parallel(dp, pp, tp, cp,
sequence_parallel)` takes (`lm_main`): each rank builds its slices of
the model (its stage at pp > 1, its tp slices) from the init or reads
them from `--load`; the zero-shot loop splits each batch's rows over dp
and sums over the dp group (tasks/zeroshot/evaluate.py), and MSDP-PROMPT
deals the samples to the dp groups, each tp/pp/cp group calling the
whole-batch API together, and gathers the completions on rank 0, which
writes the file (tasks/msdp/prompt.py). A task refuses an argv where the
JAX entry does, naming the same missing flag. Without `--load` (or
`--pretrained_checkpoint`) the model starts from its random init.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from megatron_llm_tpu_torch.parallel.mesh import (
    destroy_parallel,
    get_context,
    maybe_initialize_distributed,
    rank_device,
)


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


def _tokenizer(args, default_type):
    from megatron_llm_tpu_torch.tokenizer import build_tokenizer

    return build_tokenizer(
        args.tokenizer_type or default_type, vocab_file=args.vocab_file,
        merges_file=args.merges_file, tokenizer_model=args.tokenizer_model,
        make_vocab_size_divisible_by=args.make_vocab_size_divisible_by,
        tensor_parallel_size=args.tensor_model_parallel_size,
        null_vocab_size=args.null_vocab_size)


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


def encoder_layout(args, mcfg, pcfg, device):
    """Refuse pp and cp with the JAX entry's message (:101-104) and
    install the dp x tp layout on this rank's `device`. `main` destroys
    the layout."""
    from megatron_llm_tpu_torch.pretrain_bert import (
        check_encoder_layout,
        initialize_encoder_parallel,
    )

    check_encoder_layout(pcfg, "encoder",
                         "encoder finetuning tasks don't support cp")
    initialize_encoder_parallel(args, mcfg, pcfg, device)


def whole_params(params: dict, cfg) -> dict:
    """The whole tree of this rank's slices (a collective every rank
    enters); `params` itself at world size 1."""
    from megatron_llm_tpu_torch.parallel.sharding import gather_params

    ctx = get_context()
    if ctx is None or ctx.world_size == 1:
        return params
    return gather_params(params, ctx, cfg)


def save_whole(path: str, params: dict, cfg) -> None:
    """Rank 0 saves the whole tree as iteration 0, weights only."""
    from megatron_llm_tpu_torch.training.checkpointing import (
        save_checkpoint,
    )

    ctx = get_context()
    if ctx is None or ctx.rank == 0:
        save_checkpoint(path, 0, params, None, cfg)


def finetune_main(args, device, losses=None):
    """Classification finetuning (JAX :77-183); returns (params, best
    validation accuracy, final validation accuracy or None)."""
    from megatron_llm_tpu_torch.arguments import args_to_configs
    from megatron_llm_tpu_torch.models import Classification, MultipleChoice
    from megatron_llm_tpu_torch.tasks.finetune_utils import (
        accuracy,
        finetune,
    )

    tokenizer = _tokenizer(args, "BertWordPieceLowerCase")
    args.model_name = "bert"
    mcfg, pcfg, tcfg, _ = args_to_configs(args, tokenizer.vocab_size)
    mcfg = dataclasses.replace(mcfg, add_binary_head=False)
    encoder_layout(args, mcfg, pcfg, device)
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
        tcfg=tcfg, pcfg=pcfg, log_interval=args.log_interval,
        losses=losses)
    final = None
    if valid_ds is not None:
        final = accuracy(model, params, valid_ds, args.micro_batch_size)
        print(f"final validation accuracy: {final:.4f} (best {best:.4f})",
              flush=True)
    params = whole_params(params, model.cfg)
    if args.save:
        save_whole(args.save, params, mcfg)
        print(f"saved finetuned weights to {args.save}", flush=True)
    return params, best, final


def _biencoder(args, device, checkpoint):
    """(model, params, tokenizer, tcfg) of the retrieval tasks:
    BERT towers from the base flags, the weights of `checkpoint`'s
    newest save, or the random init without one; across ranks this
    rank's slices of them."""
    from megatron_llm_tpu_torch.arguments import args_to_configs
    from megatron_llm_tpu_torch.models.biencoder import BiEncoderModel

    tokenizer = _tokenizer(args, "BertWordPieceLowerCase")
    args.model_name = "bert"
    mcfg, pcfg, tcfg, _ = args_to_configs(args, tokenizer.vocab_size)
    mcfg = dataclasses.replace(mcfg, add_binary_head=False)
    encoder_layout(args, mcfg, pcfg, device)
    model = BiEncoderModel(
        mcfg, projection_dim=args.biencoder_projection_dim,
        shared_query_context_model=args.biencoder_shared_query_context_model,
        device=device)
    from megatron_llm_tpu_torch.parallel.sharding import shard_params
    from megatron_llm_tpu_torch.training.checkpointing import (
        load_checkpoint,
    )

    if checkpoint:
        restored = load_checkpoint(checkpoint, model.abstract_params(),
                                   None, None, finetune=True,
                                   no_load_optim=True, device=device)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint found in {checkpoint}")
        params = restored[0]
    else:
        params = model.init(seed=tcfg.seed)
    return model, shard_params(params, get_context(), mcfg), tokenizer, tcfg


def retriever_eval_main(args, device):
    """RETRIEVER-EVAL and ICT-ZEROSHOT-NQ (JAX :186-250): the evidence
    embedded by the context tower (or read from `--embedding_path`), the
    questions by the query tower, the top-k hit rates printed. Returns
    (the evaluator, {split: (rates, stats)})."""
    from megatron_llm_tpu_torch.tasks.orqa.evaluate import (
        ORQAEvaluator,
        read_evidence_tsv,
    )

    if not args.evidence_data_path:
        raise SystemExit("--evidence_data_path is required")
    if not (args.qa_data_dev or args.qa_data_test):
        raise SystemExit("--qa_data_dev and/or --qa_data_test is required")
    model, params, tokenizer, _ = _biencoder(args, device, args.load)
    evaluator = ORQAEvaluator(model, params, tokenizer,
                              seq_length=args.retriever_seq_length,
                              batch_size=args.micro_batch_size)
    docs = read_evidence_tsv(args.evidence_data_path)
    if args.embedding_path:
        print(f" > loading prebuilt index {args.embedding_path} ...",
              flush=True)
        evaluator.load_index(docs, args.embedding_path)
    else:
        print(f" > embedding {len(docs)} evidence blocks ...", flush=True)
        evaluator.build_index(docs)
    results = {}
    for split, path in (("DEV", args.qa_data_dev),
                        ("TEST", args.qa_data_test)):
        if path:
            results[split] = evaluator.evaluate(
                path, split, topk=args.retriever_topk,
                match_type=args.match)
    return evaluator, results


def retriever_finetune_main(args, device, losses=None):
    """RET-FINETUNE-NQ (JAX :252-317): supervised biencoder finetuning
    from a biencoder checkpoint (`--pretrained_checkpoint`, or `--load`);
    returns the trained params."""
    from megatron_llm_tpu_torch.tasks.orqa.supervised import (
        OpenRetrievalDataset,
        finetune_retriever,
    )

    if not args.train_data:
        raise SystemExit("--train_data (DPR-format json) is required")
    # --load is the generic flag: an alias of --pretrained_checkpoint
    model, params, tokenizer, tcfg = _biencoder(
        args, device, args.pretrained_checkpoint or args.load)
    train_ds = OpenRetrievalDataset(
        args.train_data[0], tokenizer,
        max_seq_length=args.retriever_seq_length,
        use_hard_negatives=args.use_hard_negatives, seed=tcfg.seed)
    valid_ds = (OpenRetrievalDataset(
        args.valid_data[0], tokenizer,
        max_seq_length=args.retriever_seq_length, seed=tcfg.seed)
        if args.valid_data else None)
    params = finetune_retriever(
        model, params, train_ds, valid_ds, epochs=args.epochs,
        batch_size=args.micro_batch_size, lr=tcfg.lr,
        use_hard_negatives=args.use_hard_negatives, seed=tcfg.seed,
        log_interval=args.log_interval, losses=losses)
    params = whole_params(params, model.cfg)
    if args.save:
        save_whole(args.save, params, model.cfg)
        print(f"saved finetuned retriever to {args.save}", flush=True)
    return params


def lm_layout(args, mcfg, pcfg, device):
    """Install the JAX entry's layout (JAX :374-380: `initialize_parallel(
    dp, pp, tp, cp, sequence_parallel)`) on this rank's `device` when
    there is a process group or the layout needs one; returns the
    context, None for one rank without a group. `main` destroys it."""
    from megatron_llm_tpu_torch.parallel.mesh import initialize_parallel
    from megatron_llm_tpu_torch.parallel.sharding import check_tp

    check_tp(mcfg, pcfg.tensor_parallel_size)
    if not (dist.is_initialized() or pcfg.world_size > 1):
        return None
    return initialize_parallel(
        dp=pcfg.data_parallel_size, pp=pcfg.pipeline_parallel_size,
        tp=pcfg.tensor_parallel_size, cp=pcfg.context_parallel_size,
        sequence_parallel=pcfg.sequence_parallel,
        backend=args.distributed_backend, device=device)


def lm_params(args, model, mcfg, tcfg, ctx, device) -> dict:
    """This rank's parameters: from `--load` (across ranks only the
    pieces of the rank's slices are read, `StateLayout.region`) or from
    `model.init(seed)`, cut to the rank's stage and tp slices."""
    from megatron_llm_tpu_torch.parallel.sharding import shard_params
    from megatron_llm_tpu_torch.training.checkpointing import (
        load_checkpoint,
    )
    from megatron_llm_tpu_torch.training.trainer import StateLayout

    if not args.load:
        return shard_params(model.init(seed=tcfg.seed), ctx, mcfg)
    template = model.abstract_params()
    region = None
    if ctx is not None and ctx.world_size > 1:
        region = StateLayout(ctx, mcfg, template, False, 0.0).region
    restored = load_checkpoint(args.load, template, None, mcfg,
                               no_load_optim=True, device=device,
                               region=region)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint found in {args.load}")
    return restored[0]


def lm_main(args, device):
    """WIKITEXT103, LAMBADA and MSDP-PROMPT (JAX :346-410) on the model of
    `--model_name`: its tokenizer (NullTokenizer by default), its random
    init or `--load`, on the layout of the parallelism flags. Returns
    the zero-shot metrics dict, or the MSDP-PROMPT output file."""
    from megatron_llm_tpu_torch.arguments import args_to_configs
    from megatron_llm_tpu_torch.finetune import model_provider

    if args.task == "MSDP-PROMPT":
        if not (args.sample_input_file and args.sample_output_file
                and args.prompt_file and args.prompt_type):
            raise SystemExit(
                "MSDP-PROMPT needs --sample_input_file, "
                "--sample_output_file, --prompt_file, --prompt_type")
    elif not (args.valid_data and len(args.valid_data) == 1):
        raise SystemExit("--valid_data takes exactly one path")
    tokenizer = _tokenizer(args, "NullTokenizer")
    mcfg, pcfg, tcfg, _ = args_to_configs(args, tokenizer.vocab_size)
    ctx = lm_layout(args, mcfg, pcfg, device)
    model = model_provider(args, mcfg, device=device)
    params = lm_params(args, model, mcfg, tcfg, ctx, device)

    if args.task == "MSDP-PROMPT":
        from megatron_llm_tpu_torch.tasks.msdp.prompt import (
            main as msdp_prompt_main,
        )

        return msdp_prompt_main(args, model=model, params=params,
                                tokenizer=tokenizer)

    from megatron_llm_tpu_torch.tasks.zeroshot.datasets import build_dataset
    from megatron_llm_tpu_torch.tasks.zeroshot.evaluate import (
        evaluate_and_print_results,
        is_rank_0,
    )

    data = build_dataset(
        args.task, args.valid_data[0], tokenizer, mcfg.seq_length,
        overlapping_eval=args.overlapping_eval,
        strict_lambada=args.strict_lambada)
    if is_rank_0():
        print(f" > found {len(data)} samples.")
    return evaluate_and_print_results(
        args.task, model, params, data,
        micro_batch_size=args.eval_micro_batch_size or args.micro_batch_size,
        log_interval=args.log_interval)


def main(argv=None, device="cuda", losses=None):
    """Parse `argv` (sys.argv when None) and run the task; returns what
    the task's function returns (`finetune_main`, `retriever_eval_main`,
    `retriever_finetune_main`, `lm_main`; MSDP-EVAL-F1 its (precision,
    recall, f1)). `losses`, a list, receives each finetuning step's
    loss (RET-FINETUNE-NQ: its (loss, in-batch top-1))."""
    from megatron_llm_tpu_torch.arguments import build_base_parser

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tasks.main: no CUDA device (call "
                           "main(argv, device='cpu') to run on the CPU)")
    args = get_tasks_args(build_base_parser()).parse_args(argv)
    # torchrun's group first (a rank's device): dp defaults to the ranks
    # over tp
    device = rank_device(device)
    maybe_initialize_distributed(args.distributed_backend, device)
    try:
        out = _run(args, device, losses)
    finally:
        destroy_parallel()
    print("done :-)")
    return out


def _run(args, device, losses):
    if args.task in ("MNLI", "QQP", "RACE"):
        out = finetune_main(args, device, losses)
    elif args.task == "MSDP-EVAL-F1":
        # a file-against-file metric, no model
        if not (args.guess_file and args.answer_file):
            raise SystemExit(
                "MSDP-EVAL-F1 needs --guess_file and --answer_file")
        from megatron_llm_tpu_torch.tasks.msdp.evaluate import (
            main as msdp_eval_main,
        )

        out = msdp_eval_main(args)
    elif args.task in ("RETRIEVER-EVAL", "ICT-ZEROSHOT-NQ"):
        out = retriever_eval_main(args, device)
    elif args.task == "RET-FINETUNE-NQ":
        out = retriever_finetune_main(args, device, losses)
    else:
        out = lm_main(args, device)
    return out


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
