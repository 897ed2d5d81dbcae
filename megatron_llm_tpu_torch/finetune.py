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
"""

from __future__ import annotations

import torch

from megatron_llm_tpu_torch.arguments import args_to_configs, build_base_parser
from megatron_llm_tpu_torch.models import FalconModel, GPTModel, LlamaModel
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
    model and datasets, and train; returns the final `TrainState`."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("finetune: no CUDA device (call "
                           "main(argv, device='cpu') to train on the CPU)")
    args = build_base_parser().parse_args(argv)
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
    print(f"device: {device}; microbatches {pcfg.num_microbatches} of "
          f"{tcfg.micro_batch_size}", flush=True)
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
    main()
