"""Command-line flags -> typed configs (port of arguments.py).

`build_base_parser` has the JAX package's flags with the same spellings,
defaults and audit buckets (every reference flag is supported, owned by
an entry script, SUBSUMED: accepted because the behaviour always holds,
or DESCOPED: rejected with the reason). `args_to_configs` maps them onto
the port's `ModelConfig` (torch dtypes), `ParallelConfig` and
`TrainConfig`, plus the `DataArgs`.

A flag that selects a part of the system the port does not run yet
raises ValueError naming its slice of ROADMAP.md, never silently
ignored: the overlap schedulers (the next A4 PR), the telemetry flags
(A3.8), and the BERT and T5 families and post-LN layers (A6). GPT,
Llama, CodeLlama and Falcon (with its parallel attention and parallel
layernorm) build, with every single-card training mode (the recompute
policies and block recompute, fp16 with its loss scaler, hidden,
attention and LIMA dropout) and tensor, sequence, data, pipeline (with
`--pipeline_remat`) and context parallelism with the ZeRO-1 optimizer
under torchrun.
`--distributed_backend {nccl,gloo}` is the reference's flag, which the
JAX package descopes (XLA has no backend choice): torch needs one, so
the port takes it (ROADMAP.md C, accepted divergences).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from dataclasses import dataclass
from typing import List, Optional

import torch

from megatron_llm_tpu_torch.config import (
    ParallelConfig,
    TrainConfig,
    codellama_config,
    falcon_config,
    gpt_config,
    llama_config,
)


@dataclass
class DataArgs:
    data_path: Optional[List[str]] = None
    # separate per-split corpora (exclusive with data_path + split)
    train_data_path: Optional[List[str]] = None
    valid_data_path: Optional[List[str]] = None
    test_data_path: Optional[List[str]] = None
    split: str = "969,30,1"
    tokenizer_type: Optional[str] = None
    vocab_file: Optional[str] = None
    merges_file: Optional[str] = None
    tokenizer_model: Optional[str] = None
    vocab_extra_ids: int = 0
    vocab_extra_ids_list: Optional[str] = None
    new_tokens: bool = True
    seq_length: int = 2048
    reset_position_ids: bool = False
    reset_attention_mask: bool = False
    eod_mask_loss: bool = False
    null_vocab_size: Optional[int] = None
    dataloader_type: str = "single"


# ---------------------------------------------------------------------------
# The reference flag-surface audit: the same buckets as the JAX package's
# tables, with the port's reasons.
# ---------------------------------------------------------------------------

SUBSUMED_FLAGS = {
    "--attention_softmax_in_fp32":
        "softmax statistics are always fp32 (models/attention.py and the "
        "flash kernels)",
    "--accumulate_allreduce_grads_in_fp32":
        "microbatch gradients always accumulate in the fp32 params' .grad "
        "(training/train_step.py)",
    "--data_impl":
        "one mmap-backed indexed-dataset implementation; "
        "'infer'/'mmap'/'lazy'/'cached' all map to it "
        "(data/indexed_dataset.py)",
    "--mmap_warmup":
        "mmap pages fault in on demand; no warmup pass needed",
    "--no_masked_softmax_fusion":
        "no fused masked-softmax kernel exists to disable (numerics "
        "identical)",
    "--no_bias_gelu_fusion":
        "bias and gelu are separate torch ops; no fusion to disable",
    "--no_bias_dropout_fusion":
        "bias and dropout are separate torch ops; no fusion to disable",
    "--no_persist_layer_norm":
        "no persistent-kernel LayerNorm variant exists",
    "--no_gradient_accumulation_fusion":
        "no fused wgrad-accumulation kernel exists to disable",
    "--no_async_tensor_model_parallel_allreduce":
        "the tensor-parallel all-reduces are synchronous "
        "(parallel/mappings.py)",
    "--no_contiguous_buffers_in_local_ddp":
        "one card: no DDP buffers",
    "--empty_unused_memory_level":
        "PyTorch's caching allocator keeps freed blocks (the reference's "
        "level 0)",
    "--use_ring_exchange_p2p":
        "one card: no pipeline stage transfers",
    "--local_rank":
        "torchrun's LOCAL_RANK picks each rank's card "
        "(parallel/mesh.py rank_device)",
    "--use_cpu_initialization":
        "params are drawn on the training device from a seeded generator",
    "--no_initialization":
        "converters never materialize random weights",
    "--no_query_key_layer_scaling":
        "query-key layer scaling is never applied (fp32 softmax makes the "
        "fp16-overflow workaround unnecessary)",
    "--distribute_saved_activations":
        "recompute checkpoints keep whole activations; under sequence "
        "parallelism they are the rank's sequence shard",
    "--no_scatter_gather_tensors_in_pipeline":
        "one card: no pipeline boundary tensors",
    "--num_workers":
        "the loader reads mmap views on the host; no worker pool",
    "--no_save_rng":
        "no generator state is saved: dropout masks derive from seed + 1 "
        "and the iteration",
    "--log_batch_size_to_tensorboard":
        "batch size is logged with every training log line",
}

DESCOPED_FLAGS = {
    "--num_layers_per_virtual_pipeline_stage":
        "interleaved/virtual pipeline is unsupported by design",
    "--fp16_lm_cross_entropy":
        "cross-entropy is computed in fp32 (parallel/cross_entropy.py)",
    "--fp32_residual_connection":
        "the residual stream follows compute_dtype; fp32 residuals are "
        "descoped for bf16 training",
    "--apply_residual_connection_post_layernorm":
        "the residual-from-LN-output variant is unsupported",
    "--init_method_xavier_uniform":
        "normal(--init_method_std) initialization only",
    "--encoder_num_layers":
        "asymmetric encoder/decoder depth is unsupported",
    "--decoder_num_layers":
        "asymmetric encoder/decoder depth is unsupported",
    "--pipeline_model_parallel_split_rank":
        "an encoder/decoder pipeline split rank has no analogue",
    "--standalone_embedding_stage":
        "a dedicated embedding pipeline stage has no analogue",
    "--data_parallel_random_init":
        "per-replica divergent init is not representable",
    "--adlr_autoresume":
        "use --autoresume_file (sentinel-file exit, parallel/multihost.py)",
    "--adlr_autoresume_interval":
        "use --autoresume_interval (see --adlr_autoresume)",
    "--head_lr_mult":
        "single LR group; per-head LR multipliers are descoped",
    "--max_tokens_to_oom":
        "the runtime-OOM guard of generation has no analogue",
    "--inference_batch_times_seqlen_threshold":
        "serving dispatch does not depend on batch*seqlen",
    "--onnx_safe":
        "no ONNX export path",
    "--no_data_sharding":
        "REALM/ICT index data machinery is descoped",
}

for _f in ("--fp8_e4m3", "--fp8_hybrid", "--fp8_margin", "--fp8_interval",
           "--fp8_amax_history_len", "--fp8_amax_compute_algo",
           "--no_fp8_wgrad", "--transformer_impl"):
    DESCOPED_FLAGS[_f] = ("FP8/TransformerEngine path is descoped (bf16 is "
                          "the training dtype)")
for _f in ("--img_h", "--img_w", "--num_channels", "--num_classes",
           "--patch_dim", "--classes_fraction", "--data_per_class_fraction",
           "--iter_per_epoch", "--sample_rate", "--dino_local_img_size",
           "--dino_local_crops_number", "--dino_head_hidden_size",
           "--dino_bottleneck_size", "--dino_freeze_last_layer",
           "--dino_norm_last_layer", "--dino_warmup_teacher_temp",
           "--dino_teacher_temp", "--dino_warmup_teacher_temp_epochs"):
    DESCOPED_FLAGS[_f] = ("vision model family is descoped (legacy in the "
                          "reference)")
for _f in ("--bert_load", "--ict_load", "--ict_head_size",
           "--block_data_path", "--retriever_report_topk_accuracies",
           "--retriever_score_scaling"):
    DESCOPED_FLAGS[_f] = "legacy REALM knob"

# reference flags owned by an entry script's own parser
ENTRY_SCRIPT_FLAGS = {
    "--mask_prob": ("pretrain_bert.py", "pretrain_t5.py"),
    "--short_seq_prob": ("pretrain_bert.py", "pretrain_t5.py"),
    "--decoder_seq_length": ("pretrain_t5.py",),
    "--titles_data_path": ("pretrain_ict.py",),
    "--query_in_block_prob": ("pretrain_ict.py",),
    "--use_one_sent_docs": ("pretrain_ict.py",),
    "--biencoder_projection_dim": ("pretrain_ict.py", "tasks/main.py"),
    "--biencoder_shared_query_context_model": ("pretrain_ict.py",
                                               "tasks/main.py"),
    "--evidence_data_path": ("tasks/main.py",
                             "tools/build_retrieval_index.py"),
    "--embedding_path": ("tasks/main.py", "tools/build_retrieval_index.py"),
    "--indexer_batch_size": ("tools/build_retrieval_index.py",),
    "--indexer_log_interval": ("tools/build_retrieval_index.py",),
    "--retriever_seq_length": ("tasks/main.py",
                               "tools/build_retrieval_index.py"),
}

_A3_8 = "the trainer's telemetry hooks (ROADMAP.md A3.8)"
_A4 = "the next A4 PR (ROADMAP.md A4)"
_A6 = "the remaining model families (ROADMAP.md A6)"

# flags of later slices (parser dest -> the slice): a value other than
# the parser's default raises
LATER_FLAGS = {
    **dict.fromkeys((
        "tensorboard_dir", "tensorboard_log_interval",
        "tensorboard_queue_size", "log_timers_to_tensorboard",
        "log_validation_ppl_to_tensorboard", "log_memory_to_tensorboard",
        "log_world_size_to_tensorboard", "wandb_logger", "wandb_project",
        "wandb_entity", "wandb_id", "wandb_resume", "wandb_api_key",
        "profile", "profile_step_start", "profile_step_end", "profile_dir",
        "profile_step_range", "trace_dir", "flight_record_dir",
        "flight_recorder_size", "device_cost_registry", "chip_spec",
        "perf_sentinel_ksigma", "perf_sentinel_window",
        "perf_sentinel_patience"), _A3_8),
    **dict.fromkeys((
        "overlap_grad_reduce", "overlap_param_gather",
        "async_pipeline_dispatch"), _A4),
    "use_post_ln": _A6,
}


def build_base_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="megatron_llm_tpu_torch "
                                "arguments", allow_abbrev=False)
    g = p.add_argument_group("network size")
    g.add_argument("--model_name", default="gpt",
                   choices=["gpt", "llama", "llama2", "codellama", "falcon",
                            "bert", "t5"])
    g.add_argument("--model_size", type=int, default=7)
    g.add_argument("--num_layers", type=int, default=None)
    g.add_argument("--hidden_size", type=int, default=None)
    g.add_argument("--ffn_hidden_size", type=int, default=None)
    g.add_argument("--num_attention_heads", type=int, default=None)
    g.add_argument("--num_attention_heads_kv", type=int, default=None)
    g.add_argument("--kv_channels", type=int, default=None)
    g.add_argument("--max_position_embeddings", type=int, default=None)
    g.add_argument("--make_vocab_size_divisible_by", type=int, default=128)
    g.add_argument("--layernorm_epsilon", type=float, default=None)
    g.add_argument("--init_method_std", type=float, default=None)
    g.add_argument("--use_bias", action="store_true", default=None)
    g.add_argument("--use_rms_norm", action="store_true", default=None)
    g.add_argument("--use_post_ln", action="store_true", default=None)
    g.add_argument("--glu_activation", type=str, default=None)
    g.add_argument("--position_embedding_type", type=str, default=None)
    g.add_argument("--rope_scaling_factor", type=float, default=None,
                   help="linear RoPE position interpolation divisor")
    g.add_argument("--rope_theta", type=float, default=None,
                   help="rotary base frequency (default 10000)")
    g.add_argument("--attention_window_size", type=int, default=None,
                   help="sliding-window reach of the paged serving "
                        "kernels (training ignores it; None = full causal)")
    g.add_argument("--parallel_attn", action="store_true", default=None)
    g.add_argument("--parallel_layernorm", action="store_true", default=None)
    g.add_argument("--no_tie_embed_logits", action="store_true")

    g = p.add_argument_group("regularization")
    g.add_argument("--hidden_dropout", type=float, default=None)
    g.add_argument("--attention_dropout", type=float, default=None)
    g.add_argument("--lima_dropout", action="store_true", default=None)
    g.add_argument("--weight_decay", type=float, default=0.01)
    g.add_argument("--start_weight_decay", type=float, default=None)
    g.add_argument("--end_weight_decay", type=float, default=None)
    g.add_argument("--weight_decay_incr_style", default="constant")
    g.add_argument("--clip_grad", type=float, default=1.0)
    g.add_argument("--adam_beta1", type=float, default=0.9)
    g.add_argument("--adam_beta2", type=float, default=0.999)
    g.add_argument("--adam_eps", type=float, default=1e-8)
    g.add_argument("--sgd_momentum", type=float, default=0.9)

    g = p.add_argument_group("training")
    g.add_argument("--micro_batch_size", type=int, default=1)
    g.add_argument("--global_batch_size", type=int, default=None)
    g.add_argument("--rampup_batch_size", nargs=3, type=int, default=None)
    g.add_argument("--train_iters", type=int, default=None)
    g.add_argument("--train_samples", type=int, default=None)
    g.add_argument("--exit_interval", type=int, default=None)
    g.add_argument("--exit_duration_in_mins", type=float, default=None)
    g.add_argument("--exit_signal_handler", action="store_true")
    g.add_argument("--autoresume_file", type=str, default=None)
    g.add_argument("--autoresume_interval", type=int, default=50)
    g.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    g.add_argument("--dataloader_type", default="single",
                   choices=["single", "cyclic"])
    g.add_argument("--use_flash_attn", action="store_true", default=None)
    g.add_argument("--no_use_flash_attn", dest="use_flash_attn",
                   action="store_false")
    g.add_argument("--recompute_granularity", default=None,
                   choices=[None, "full", "selective"])
    g.add_argument("--recompute_activations", action="store_true")
    g.add_argument("--remat_policy", default=None,
                   choices=[None, "full", "selective", "save_dots",
                            "offload", "none"])
    g.add_argument("--recompute_method", default=None,
                   choices=[None, "uniform", "block"])
    g.add_argument("--recompute_num_layers", type=int, default=None)
    g.add_argument("--sequence_parallel", action="store_true")

    g = p.add_argument_group("learning rate")
    g.add_argument("--lr", type=float, default=1e-4)
    g.add_argument("--lr_decay_style", default="linear",
                   choices=["constant", "linear", "cosine",
                            "inverse-square-root"])
    g.add_argument("--lr_decay_iters", type=int, default=None)
    g.add_argument("--lr_decay_samples", type=int, default=None)
    g.add_argument("--lr_warmup_fraction", type=float, default=None)
    g.add_argument("--lr_warmup_iters", type=int, default=0)
    g.add_argument("--lr_warmup_samples", type=int, default=0)
    g.add_argument("--min_lr", type=float, default=0.0)
    g.add_argument("--use_checkpoint_opt_param_scheduler",
                   action="store_true")
    g.add_argument("--override_opt_param_scheduler", action="store_true")

    g = p.add_argument_group("checkpointing")
    g.add_argument("--save", type=str, default=None)
    g.add_argument("--save_interval", type=int, default=None)
    g.add_argument("--load", type=str, default=None)
    g.add_argument("--use_checkpoint_args", action="store_true")
    g.add_argument("--finetune", action="store_true")
    g.add_argument("--no_save_optim", action="store_true")
    g.add_argument("--no_load_optim", action="store_true")
    g.add_argument("--no_load_rng", action="store_true")
    g.add_argument("--no_async_save", dest="async_save",
                   action="store_false", default=True,
                   help="block the train loop until each checkpoint is "
                        "committed (default: the loop pays the copy to "
                        "host memory only)")
    g.add_argument("--keep_latest_n", type=int, default=None,
                   help="keep only the newest N complete checkpoints")
    g.add_argument("--loss_watchdog_ksigma", type=float, default=0.0,
                   help="skip updates whose loss exceeds median + k*sigma "
                        "of the recent-loss window; 0 disables")
    g.add_argument("--loss_watchdog_window", type=int, default=64)
    g.add_argument("--spike_rollback_patience", type=int, default=0,
                   help="after N consecutive bad steps, reload the last "
                        "complete checkpoint; 0 disables")

    g = p.add_argument_group("mixed precision")
    g.add_argument("--fp16", action="store_true")
    g.add_argument("--bf16", action="store_true")
    g.add_argument("--loss_scale", type=float, default=None)
    g.add_argument("--initial_loss_scale", type=float, default=2.0**32)
    g.add_argument("--min_loss_scale", type=float, default=1.0)
    g.add_argument("--loss_scale_window", type=int, default=1000)
    g.add_argument("--hysteresis", type=int, default=2)

    g = p.add_argument_group("distributed")
    g.add_argument("--tensor_model_parallel_size", type=int, default=1)
    g.add_argument("--pipeline_model_parallel_size", type=int, default=1)
    g.add_argument("--use_distributed_optimizer", action="store_true")
    g.add_argument("--grad_rs_bucket_mb", type=float, default=4.0)
    g.add_argument("--quantized_grad_reduce", action="store_true")
    g.add_argument("--overlap_grad_reduce", action="store_true")
    g.add_argument("--overlap_param_gather", action="store_true")
    g.add_argument("--async_pipeline_dispatch", action="store_true")
    g.add_argument("--data_parallel_size", type=int, default=None)
    g.add_argument("--context_parallel_size", type=int, default=1)
    g.add_argument("--pipeline_remat", default="tick",
                   choices=["tick", "full", "selective", "dots",
                            "save_dots", "offload", "none"])
    g.add_argument("--distributed_backend", default=None,
                   choices=["nccl", "gloo"],
                   help="torch.distributed backend (default: nccl for "
                        "CUDA, gloo for the CPU)")

    g = p.add_argument_group("validation")
    g.add_argument("--eval_iters", type=int, default=100)
    g.add_argument("--eval_interval", type=int, default=1000)

    g = p.add_argument_group("data")
    g.add_argument("--data_path", nargs="*", default=None)
    g.add_argument("--train_data_path", nargs="*", default=None)
    g.add_argument("--valid_data_path", nargs="*", default=None)
    g.add_argument("--test_data_path", nargs="*", default=None)
    g.add_argument("--split", default="969,30,1")
    g.add_argument("--seq_length", "--encoder_seq_length", type=int,
                   default=2048)
    g.add_argument("--tokenizer_type", type=str, default=None)
    g.add_argument("--vocab_file", type=str, default=None)
    g.add_argument("--merges_file", "--merge_file", type=str, default=None)
    g.add_argument("--tokenizer_model", type=str, default=None)
    g.add_argument("--vocab_extra_ids", type=int, default=0)
    g.add_argument("--vocab_extra_ids_list", type=str, default=None)
    g.add_argument("--no_new_tokens", dest="new_tokens",
                   action="store_false")
    g.add_argument("--null_vocab_size", type=int, default=None)
    g.add_argument("--reset_position_ids", action="store_true")
    g.add_argument("--reset_attention_mask", action="store_true")
    g.add_argument("--eod_mask_loss", action="store_true")
    g.add_argument("--seed", type=int, default=1234)

    g = p.add_argument_group("logging")
    g.add_argument("--log_interval", type=int, default=100)
    g.add_argument("--tensorboard_dir", type=str, default=None)
    g.add_argument("--tensorboard_log_interval", type=int, default=1)
    g.add_argument("--tensorboard_queue_size", type=int, default=1000)
    g.add_argument("--log_timers_to_tensorboard", action="store_true")
    g.add_argument("--log_validation_ppl_to_tensorboard",
                   action="store_true")
    g.add_argument("--log_memory_to_tensorboard", action="store_true")
    g.add_argument("--log_world_size_to_tensorboard", action="store_true")
    g.add_argument("--timing_log_level", type=int, default=0,
                   choices=[0, 1, 2])
    g.add_argument("--timing_log_option", default="minmax",
                   choices=["max", "minmax", "all"])
    g.add_argument("--wandb_logger", action="store_true")
    g.add_argument("--wandb_project", type=str, default=None)
    g.add_argument("--wandb_entity", type=str, default=None)
    g.add_argument("--wandb_id", type=str, default=None)
    g.add_argument("--wandb_resume", action="store_true")
    g.add_argument("--wandb_api_key", type=str, default=None)
    g.add_argument("--log_params_norm", action="store_true")
    g.add_argument("--log_num_zeros_in_grad", action="store_true")
    g.add_argument("--profile", action="store_true")
    g.add_argument("--profile_step_start", type=int, default=10)
    g.add_argument("--profile_step_end", type=int, default=12)
    g.add_argument("--profile_dir", type=str, default=None)
    g.add_argument("--profile_step_range", nargs=2, type=int, default=None,
                   metavar=("START", "END"))
    g.add_argument("--trace_dir", type=str, default=None)
    g.add_argument("--flight_record_dir", type=str, default=None)
    g.add_argument("--flight_recorder_size", type=int, default=4096)
    g.add_argument("--device_cost_registry", action="store_true")
    g.add_argument("--chip_spec", type=str, default=None,
                   choices=["v5e", "v5p", "v4"])
    g.add_argument("--perf_sentinel_ksigma", type=float, default=0.0)
    g.add_argument("--perf_sentinel_window", type=int, default=64)
    g.add_argument("--perf_sentinel_patience", type=int, default=8)

    # the audit buckets: nargs="*" absorbs `--flag` and `--flag value ...`
    for flag in SUBSUMED_FLAGS:
        p.add_argument(flag, nargs="*", default=None, help=argparse.SUPPRESS,
                       dest="_subsumed_" + flag.lstrip("-"))
    for flag in DESCOPED_FLAGS:
        p.add_argument(flag, nargs="*", default=None, help=argparse.SUPPRESS,
                       dest="_descoped_" + flag.lstrip("-"))
    return p


def _check_later_flags(args) -> None:
    defaults = build_base_parser()
    for dest, slice_name in LATER_FLAGS.items():
        if getattr(args, dest) != defaults.get_default(dest):
            raise ValueError(f"--{dest} is not ported yet ({slice_name})")


def args_to_configs(args, padded_vocab_size: int,
                    world_size: Optional[int] = None):
    """(ModelConfig, ParallelConfig, TrainConfig, DataArgs) of the parsed
    namespace, with the JAX package's derivations (padded vocabulary to
    a multiple of make_vocab_size_divisible_by * tp, global batch,
    microbatch count per rank, max positions from seq_length).
    `--data_parallel_size` defaults to the ranks the layout leaves:
    `world_size` (the process group's, 1 without one) over tp x pp x cp
    (JAX :630-666); a pp that does not divide `--num_layers` is refused
    here, and so is cp > 1 for the families whose masks are padding
    masks (BERT, T5)."""
    for flag, reason in DESCOPED_FLAGS.items():
        if getattr(args, "_descoped_" + flag.lstrip("-"), None) is not None:
            raise SystemExit(f"{flag}: unsupported - {reason}")
    for flag, reason in SUBSUMED_FLAGS.items():
        if getattr(args, "_subsumed_" + flag.lstrip("-"), None) is not None:
            print(f"note: {flag} accepted; {reason}", file=sys.stderr)
    _check_later_flags(args)

    if args.recompute_activations and args.recompute_granularity is None:
        args.recompute_granularity = "selective"
    if args.data_path and (args.train_data_path or args.valid_data_path
                           or args.test_data_path):
        raise SystemExit("--data_path and --train_data_path/"
                         "--valid_data_path/--test_data_path are mutually "
                         "exclusive")

    overrides = {}
    for name in (
            "num_layers", "hidden_size", "ffn_hidden_size",
            "num_attention_heads", "num_attention_heads_kv", "kv_channels",
            "layernorm_epsilon", "init_method_std", "glu_activation",
            "position_embedding_type", "rope_scaling_factor", "rope_theta",
            "attention_window_size", "hidden_dropout", "attention_dropout",
            "lima_dropout", "use_flash_attn", "recompute_granularity",
            "remat_policy",
            "recompute_method", "recompute_num_layers", "use_bias",
            "use_rms_norm", "parallel_attn", "parallel_layernorm"):
        v = getattr(args, name)
        if v is not None:
            overrides[name] = v
    overrides["max_position_embeddings"] = (
        args.max_position_embeddings
        if args.max_position_embeddings is not None else args.seq_length)
    overrides["make_vocab_size_divisible_by"] = \
        args.make_vocab_size_divisible_by
    if args.no_tie_embed_logits:
        overrides["tie_embed_logits"] = False
    if args.fp16:
        overrides["params_dtype"] = torch.float32
        overrides["compute_dtype"] = torch.float16

    tp = args.tensor_model_parallel_size
    pp = args.pipeline_model_parallel_size
    cp = args.context_parallel_size or 1
    name = args.model_name
    if cp > 1 and name in ("bert", "t5"):
        # JAX :632-649
        raise SystemExit(
            f"--context_parallel_size {cp} with --model_name {name}: "
            "BERT/T5-style padding masks are dense attention masks, "
            "which context parallelism cannot shard (ring attention has "
            "no dense-mask path, and a gathered fallback would silently "
            "lose the memory scaling cp exists for). Use "
            "--context_parallel_size 1 for this model family, or move "
            "the parallelism to --tensor_model_parallel_size / "
            "--pipeline_model_parallel_size / data parallel "
            "(docs/GUIDE.md, 'Masks').")
    if name in ("llama", "llama2"):
        mcfg = llama_config(args.model_size,
                            version=1 if name == "llama" else 2,
                            seq_length=args.seq_length, tp=tp, **overrides)
    elif name == "codellama":
        mcfg = codellama_config(args.model_size, seq_length=args.seq_length,
                                **overrides)
    elif name == "falcon":
        mcfg = falcon_config(args.model_size, seq_length=args.seq_length,
                             tp=tp, **overrides)
    elif name == "gpt":
        mcfg = gpt_config(
            num_layers=overrides.pop("num_layers", 12),
            hidden_size=overrides.pop("hidden_size", 768),
            num_attention_heads=overrides.pop("num_attention_heads", 12),
            seq_length=args.seq_length, tp=tp, **overrides)
    else:
        raise ValueError(f"--model_name {name} is not ported yet ({_A6})")
    if padded_vocab_size:
        mcfg = dataclasses.replace(
            mcfg, padded_vocab_size=mcfg.pad_vocab_size(padded_vocab_size,
                                                        tp))

    if world_size is None:
        import torch.distributed as dist

        world_size = dist.get_world_size() if dist.is_initialized() else 1
    if pp > 1 and mcfg.num_layers % pp:
        raise ValueError(f"--pipeline_model_parallel_size {pp} does not "
                         f"divide --num_layers {mcfg.num_layers}: each "
                         f"stage holds num_layers / pp layers")
    if args.seq_length % cp:
        raise ValueError(f"--context_parallel_size {cp} does not divide "
                         f"--seq_length {args.seq_length}: each cp rank "
                         f"holds seq_length / cp positions")
    dp = args.data_parallel_size
    if dp is None:
        dp = max(1, world_size // (tp * pp * cp))
    gbs = args.global_batch_size or args.micro_batch_size * dp
    pcfg = ParallelConfig(
        data_parallel_size=dp, pipeline_parallel_size=pp,
        tensor_parallel_size=tp, context_parallel_size=cp,
        sequence_parallel=args.sequence_parallel,
        use_distributed_optimizer=args.use_distributed_optimizer,
        grad_rs_bucket_mb=args.grad_rs_bucket_mb,
        quantized_grad_reduce=args.quantized_grad_reduce,
        num_microbatches=gbs // (args.micro_batch_size * dp),
        pipeline_remat=args.pipeline_remat)
    tcfg = TrainConfig(
        micro_batch_size=args.micro_batch_size,
        global_batch_size=gbs,
        rampup_batch_size=tuple(args.rampup_batch_size)
        if args.rampup_batch_size else None,
        train_iters=args.train_iters,
        train_samples=args.train_samples,
        exit_interval=args.exit_interval,
        exit_duration_in_mins=args.exit_duration_in_mins,
        exit_signal_handler=args.exit_signal_handler,
        autoresume_file=args.autoresume_file,
        autoresume_interval=args.autoresume_interval,
        optimizer=args.optimizer,
        lr=args.lr,
        min_lr=args.min_lr,
        lr_decay_style=args.lr_decay_style,
        lr_decay_iters=args.lr_decay_iters,
        lr_decay_samples=args.lr_decay_samples,
        lr_warmup_iters=args.lr_warmup_iters,
        lr_warmup_samples=args.lr_warmup_samples,
        lr_warmup_fraction=args.lr_warmup_fraction,
        use_checkpoint_opt_param_scheduler=(
            args.use_checkpoint_opt_param_scheduler),
        override_opt_param_scheduler=args.override_opt_param_scheduler,
        weight_decay=args.weight_decay,
        start_weight_decay=args.start_weight_decay,
        end_weight_decay=args.end_weight_decay,
        weight_decay_incr_style=args.weight_decay_incr_style,
        clip_grad=args.clip_grad,
        adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2,
        adam_eps=args.adam_eps,
        sgd_momentum=args.sgd_momentum,
        fp16=args.fp16,
        # --bf16 --fp16 together trip the exclusivity check
        bf16=args.bf16 or not args.fp16,
        loss_scale=args.loss_scale,
        initial_loss_scale=args.initial_loss_scale,
        min_loss_scale=args.min_loss_scale,
        loss_scale_window=args.loss_scale_window,
        hysteresis=args.hysteresis,
        save=args.save,
        load=args.load,
        save_interval=args.save_interval,
        finetune=args.finetune,
        no_save_optim=args.no_save_optim,
        no_load_optim=args.no_load_optim,
        no_load_rng=args.no_load_rng,
        async_save=args.async_save,
        keep_latest_n=args.keep_latest_n,
        loss_watchdog_ksigma=args.loss_watchdog_ksigma,
        loss_watchdog_window=args.loss_watchdog_window,
        spike_rollback_patience=args.spike_rollback_patience,
        log_interval=args.log_interval,
        eval_interval=args.eval_interval,
        eval_iters=args.eval_iters,
        timing_log_level=args.timing_log_level,
        timing_log_option=args.timing_log_option,
        log_params_norm=args.log_params_norm,
        log_num_zeros_in_grad=args.log_num_zeros_in_grad,
        seed=args.seed,
    )
    dargs = DataArgs(
        data_path=args.data_path,
        train_data_path=args.train_data_path,
        valid_data_path=args.valid_data_path,
        test_data_path=args.test_data_path,
        split=args.split,
        tokenizer_type=args.tokenizer_type,
        vocab_file=args.vocab_file,
        merges_file=args.merges_file,
        tokenizer_model=args.tokenizer_model,
        vocab_extra_ids=args.vocab_extra_ids,
        vocab_extra_ids_list=args.vocab_extra_ids_list,
        new_tokens=args.new_tokens,
        seq_length=args.seq_length,
        reset_position_ids=args.reset_position_ids,
        reset_attention_mask=args.reset_attention_mask,
        eod_mask_loss=args.eod_mask_loss,
        null_vocab_size=args.null_vocab_size,
        dataloader_type=args.dataloader_type,
    )
    return mcfg, pcfg, tcfg, dargs
