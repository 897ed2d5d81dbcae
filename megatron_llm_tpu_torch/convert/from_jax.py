"""Weight bridge from the JAX package's parameter tree.

`params_from_jax` takes the tree `GPTModel.init` returns in the JAX
package, with its leaves as numpy arrays (`jax.tree.map(np.asarray,
params)`), and builds the port's tree: the same leaf names, the same
shapes and layouts, the same values. No transposition is needed because
the port keeps the JAX package's layouts, which are:

- `layers.attention.wqkv` (L, h, (heads + 2 kv_heads) * d): the grouped
  layout, output columns ordered [group g: q_g0 .. q_g(qpk-1), k_g, v_g]
  with d columns each (`models/attention.split_qkv` reshapes it to
  (b, s, g, qpk + 2, d));
- `layers.mlp.w1` (L, h, 2, ffn) for GLU models: gate at index 0, up at
  index 1 (the reference checkpoint packs [up; gate] along one 2 ffn
  axis; the JAX converter reorders it into this layout);
- `lm_head` (h, V): the untied head of Llama, applied as x @ lm_head;
- RoPE rotates interleaved pairs (x[2i], x[2i+1]) (Meta's convention), so
  q/k columns need no half-split permutation.

The JAX package's reference-checkpoint converter states the same facts in
its module docstring (megatron_llm_tpu/convert/megatron_torch.py:12-19).

`optimizer_state_from_jax` carries the JAX optimizer state (step, m, v)
across the same way, so a run can resume part-way on the port. The port
trains on the stacked layer tree itself (`transformer_stack` unbinds it
once per forward), so no stacked <-> per-layer converter is needed.
`checkpoint_from_jax` writes a whole port checkpoint from a JAX
checkpoint's restored leaves and its meta.json, which `--load` then
resumes at any layout: the files hold whole tensors, and a rank cuts
its slices at load. Across ranks, `rank_params_from_jax` gives a rank
its tensor-parallel slices of the JAX tree (`params_from_jax`, then
parallel/sharding.shard_params), the shards the JAX package's
`param_specs` name for that rank's devices.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: jax hands out read-only buffers
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 has no torch twin
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: dict, cfg, device="cuda") -> dict:
    """The port's parameter tree from the JAX tree of numpy arrays."""
    expected = cfg.qkv_projection_size
    got = np.asarray(tree["layers"]["attention"]["wqkv"]).shape[-1]
    if got != expected:
        raise ValueError(f"wqkv width {got} does not match the config's "
                         f"grouped qkv width {expected}")

    def conv(t):
        return {k: conv(v) if isinstance(v, dict) else _to_tensor(v, device)
                for k, v in t.items()}

    return conv(tree)


def rank_params_from_jax(tree: dict, cfg, ctx, device="cuda") -> dict:
    """This rank's slices (parallel/sharding.py) of the port's tree from
    the JAX tree of numpy arrays; `ctx` is the parallel context (its tp
    and tp_rank, and at pp > 1 its pp and pp_rank: a stage's layers)."""
    from megatron_llm_tpu_torch.parallel.sharding import shard_params

    return shard_params(params_from_jax(tree, cfg, device), ctx, cfg)


def optimizer_state_from_jax(state, cfg, device="cuda"):
    """The port's `OptimizerState` from the JAX package's (its `step`, `m`
    and `v` as numpy arrays or trees of them, e.g. after
    `jax.tree.map(np.asarray, opt_state)`): same leaf names and layouts
    as the params, fp32; `v` is None for SGD. The fp16 loss scaler's
    state comes along with its keys and dtypes ({} for a constant scale,
    None without fp16)."""
    from megatron_llm_tpu_torch.optimizer.optimizer import OptimizerState

    def conv(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _to_tensor(t, device)

    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=device)
    scaler = getattr(state, "scaler", None)
    if scaler is not None:
        scaler = {k: torch.from_numpy(np.array(v)).to(device)
                  for k, v in scaler.items()}
    return OptimizerState(step=step, m=conv(state.m), v=conv(state.v),
                          scaler=scaler)


def checkpoint_from_jax(params_np: dict, opt_np, meta: dict,
                        save_dir: str) -> str:
    """Write the port checkpoint of a JAX one: its params and optimizer
    state as numpy leaves (`opt_np` may be None: a weights-only
    checkpoint) and its meta.json dict, whose iteration, consumed samples,
    scheduler state and config carry over. Returns the directory
    written, which the tracker in `save_dir` names."""
    from megatron_llm_tpu_torch.training.checkpointing import (
        save_checkpoint,
    )

    c = meta["config"]
    cfg = SimpleNamespace(qkv_projection_size=c["kv_channels"] * (
        c["num_attention_heads"] + 2 * c["num_attention_heads_kv"]))
    params = params_from_jax(params_np, cfg, device="cpu")
    opt = optimizer_state_from_jax(opt_np, cfg, device="cpu") \
        if opt_np is not None else None
    return save_checkpoint(
        save_dir, meta["iteration"], params, opt,
        scheduler_state=meta.get("scheduler"),
        consumed_train_samples=meta.get("consumed_train_samples", 0),
        extra_meta={"config": c})
