"""Train or fine-tune GPT, Llama and Falcon models (port of the root
finetune.py).

    python -m megatron_llm_tpu_torch.finetune --model_name llama2 \\
        --model_size 7 --data_path corpus_text_document \\
        --tokenizer_type GPT2BPETokenizer --vocab_file vocab.json \\
        --merges_file merges.txt --train_iters 1000 --bf16 \\
        --save ckpt --load ckpt --save_interval 100

The same flags as the JAX package's entry point (`arguments.py`). It
runs on the first CUDA card; `main(argv, device="cpu")` runs on the CPU
(the tests do). BERT and T5 raise, naming their slice.

Under torchrun it trains with tensor, sequence, data, pipeline and
context parallelism and the ZeRO-1 optimizer (the fine-tuning recipe's
flags), one process per rank, each on `cuda:{LOCAL_RANK % device_count}`:

    torchrun --nproc_per_node 8 -m megatron_llm_tpu_torch.finetune \
        --model_name llama2 --model_size 7 \
        --tensor_model_parallel_size 4 --sequence_parallel \
        --pipeline_model_parallel_size 2 --pipeline_remat tick \
        --context_parallel_size 2 --use_distributed_optimizer --bf16 ...

`--data_parallel_size` defaults to the ranks over tp x pp x cp. NCCL is the
backend on CUDA; it cannot put two ranks on one card, which
`--distributed_backend gloo` can (its collectives staged through host
memory). A process group made before `main` (utils/virtual_mesh.py's
CPU ranks) is used as it is.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from megatron_llm_tpu_torch.arguments import args_to_configs, build_base_parser
from megatron_llm_tpu_torch.models import FalconModel, GPTModel, LlamaModel
from megatron_llm_tpu_torch.parallel.mesh import (
    destroy_parallel,
    initialize_parallel,
    maybe_initialize_distributed,
    rank_device,
)
from megatron_llm_tpu_torch.parallel.sharding import check_tp
from megatron_llm_tpu_torch.tokenizer import build_tokenizer
from megatron_llm_tpu_torch.training.trainer import pretrain


def model_provider(args, mcfg, device="cuda"):
    """The model of `--model_name` on `device`."""
    if args.model_name in ("llama", "llama2", "codellama"):
        return LlamaModel(mcfg, device=device)
    if args.model_name == "falcon":
        return FalconModel(mcfg, device=device)
    if args.model_name == "gpt":
        return GPTModel(mcfg, device=device)
    raise ValueError(f"--model_name {args.model_name} is not ported yet "
                     f"(the remaining model families, ROADMAP.md A6)")


def main(argv=None, device="cuda"):
    """Parse `argv` (sys.argv when None), build the tokenizer, configs,
    model and datasets, and train; returns the final `TrainState` (this
    rank's, across ranks)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("finetune: no CUDA device (call "
                           "main(argv, device='cpu') to train on the CPU)")
    args = build_base_parser().parse_args(argv)
    # the default group stays for the process (a second call reuses it;
    # the command line destroys it at exit), the context's groups go
    maybe_initialize_distributed(args.distributed_backend, device)
    try:
        return _main(args, rank_device(device))
    finally:
        destroy_parallel()


def _main(args, device):
    tokenizer = None
    vocab_size = 0
    if args.tokenizer_type:
        tokenizer = build_tokenizer(
            args.tokenizer_type, vocab_file=args.vocab_file,
            merges_file=args.merges_file,
            tokenizer_model=args.tokenizer_model,
            make_vocab_size_divisible_by=args.make_vocab_size_divisible_by,
            tensor_parallel_size=args.tensor_model_parallel_size,
            vocab_extra_ids=args.vocab_extra_ids,
            null_vocab_size=args.null_vocab_size)
        vocab_size = tokenizer.vocab_size
    mcfg, pcfg, tcfg, dargs = args_to_configs(args, vocab_size)
    if args.use_checkpoint_args and args.load:
        from megatron_llm_tpu_torch.training.checkpointing import (
            load_model_config_from_checkpoint,
        )

        mcfg = load_model_config_from_checkpoint(args.load, mcfg)
    check_tp(mcfg, pcfg.tensor_parallel_size)
    ctx = None
    if dist.is_initialized() or pcfg.world_size > 1:
        ctx = initialize_parallel(
            dp=pcfg.data_parallel_size, pp=pcfg.pipeline_parallel_size,
            tp=pcfg.tensor_parallel_size, cp=pcfg.context_parallel_size,
            sequence_parallel=pcfg.sequence_parallel,
            backend=args.distributed_backend, device=device)
    if ctx is None or ctx.rank == 0:
        print(f"device: {device}; dp {pcfg.data_parallel_size} pp "
              f"{pcfg.pipeline_parallel_size} (pipeline_remat "
              f"{pcfg.pipeline_remat}) cp {pcfg.context_parallel_size} tp "
              f"{pcfg.tensor_parallel_size} sp {pcfg.sequence_parallel} "
              f"zero1 {pcfg.use_distributed_optimizer} backend "
              f"{ctx.backend if ctx else None} staged "
              f"{bool(ctx and ctx.staged)}; microbatches "
              f"{pcfg.num_microbatches} of {tcfg.micro_batch_size} a rank",
              flush=True)
    model = model_provider(args, mcfg, device=device)

    def dataset_provider(train_val_test_num_samples):
        from megatron_llm_tpu_torch.data import (
            build_train_valid_test_datasets,
        )

        if not (dargs.data_path or dargs.train_data_path):
            raise ValueError("--data_path (or --train_data_path/"
                             "--valid_data_path/--test_data_path) is "
                             "required")
        return build_train_valid_test_datasets(
            data_prefix=dargs.data_path, splits_string=dargs.split,
            train_valid_test_num_samples=train_val_test_num_samples,
            seq_length=mcfg.seq_length, seed=tcfg.seed,
            train_data_prefix=dargs.train_data_path,
            valid_data_prefix=dargs.valid_data_path,
            test_data_prefix=dargs.test_data_path)

    return pretrain(
        model, tcfg, pcfg, dataset_provider,
        eod_token=tokenizer.eod if tokenizer else None,
        reset_position_ids=dargs.reset_position_ids,
        reset_attention_mask=dargs.reset_attention_mask,
        eod_mask_loss=dargs.eod_mask_loss,
        dataloader_type=dargs.dataloader_type)


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
