"""Re-save a checkpoint, optionally as a weights-only release (port of
tools/reshard_checkpoint.py).

Any layout resumes the port's checkpoints of any other: a save across
ranks writes per-rank pieces that each load reads its slice from, and
a world size 1 save whole tensors (training/checkpointing.py). This
tool loads the newest (or a given) iteration's weights on the host, the
pieces reassembled, and writes them as whole tensors to another
directory, for example as the `release` layout the converters and the
serving launcher read. It touches no device.

    python -m megatron_llm_tpu_torch.tools.reshard_checkpoint \\
        --load ckpts/run1 --save ckpts/out --model_name llama2 \\
        --model_size 7 [--release] [--iteration N]
"""

from __future__ import annotations

from megatron_llm_tpu_torch.arguments import args_to_configs, build_base_parser
from megatron_llm_tpu_torch.training.checkpointing import (
    load_checkpoint,
    load_model_config_from_checkpoint,
    save_checkpoint,
)


def main(argv=None) -> str:
    """Returns the directory written."""
    from megatron_llm_tpu_torch.finetune import model_provider

    p = build_base_parser()
    p.add_argument("--release", action="store_true",
                   help="write a weights-only release checkpoint")
    p.add_argument("--iteration", type=int, default=None)
    args = p.parse_args(argv)
    if not (args.load and args.save):
        raise SystemExit("--load and --save are required")
    mcfg = args_to_configs(args, 0, world_size=1)[0]
    # the checkpoint's own architecture (its padded vocabulary above all)
    mcfg = load_model_config_from_checkpoint(args.load, mcfg)
    model = model_provider(args, mcfg, device="meta")
    restored = load_checkpoint(args.load, model.abstract_params(),
                               no_load_optim=True, iteration=args.iteration,
                               device="cpu")
    if restored is None:
        raise SystemExit(f"no checkpoint found in {args.load}")
    params, _, meta, iteration = restored
    out = save_checkpoint(
        args.save, iteration, params, None, mcfg,
        consumed_train_samples=meta.get("consumed_train_samples", 0),
        release=args.release)
    print(f"re-saved iteration {iteration} from {args.load} to {out}"
          f"{' (release)' if args.release else ''}", flush=True)
    return out


if __name__ == "__main__":
    main()
