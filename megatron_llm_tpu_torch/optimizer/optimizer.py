"""Mixed-precision AdamW / SGD with clipping and the skip gate (port of
optimizer/optimizer.py).

fp32 params, fp32 m and v, fp32 grads in; the update is plain torch ops
with the JAX package's semantics: the fp32 global grad norm, the clip
coefficient min(clip / (norm + 1e-6), 1), the AdamW form
p32 - lr * (u + wd * p32) with bias correction from the step count, 1-D
params (norm scales, biases) never decayed, the SGD momentum branch, and a
skipped step (non-finite grad norm or the caller's `found_inf`) that
leaves params and state as they were. The skip is a `torch.where` on the
card: nothing is read back on the host.

Unlike the JAX package's pure function, `optimizer_step` updates params,
m, v and step IN PLACE (the state is the size of the model three times
over; a second copy would not fit next to it on one card) and returns
them. Under fp16 a loss scaler (optimizer/grad_scaler.py) rides in the
state: the gradients arrive unscaled, and the scaler reacts to their
overflow only, never to the caller's skip gate (JAX :126-138).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from megatron_llm_tpu_torch.config import TrainConfig


def tree_leaves(tree) -> list:
    """Leaves of nested dicts, lists and tuples (dict keys sorted, the
    order jax.tree uses)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


class OptimizerState(NamedTuple):
    step: torch.Tensor  # int32 scalar on the params' device
    m: Any  # first moment (adam) or momentum buffer (sgd); params-shaped
    v: Optional[Any]  # second moment (adam) or None (sgd)
    # fp16 loss-scaler state ({} constant, scale and trackers dynamic);
    # None without fp16
    scaler: Optional[dict] = None


def global_grad_norm(grads, reduce_fn=None) -> torch.Tensor:
    """L2 norm over every leaf as an fp32 scalar (JAX :45-53). Per-leaf
    norms first, so no squared copy of a leaf is made; they accumulate in
    fp64, so that the sum does not depend on a device's reduction order
    (XLA sums its fp32 squares pairwise; a straight fp32 sum over a
    million-element leaf drifts by ~1e-5 relative). Over ranks that hold
    shards, `reduce_fn` (optimizer/zero1.sum_over_layout) sums the
    per-leaf squares of the whole model."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float64)
             for g in tree_leaves(grads)]
    if reduce_fn is not None:
        return torch.sqrt(reduce_fn([n * n for n in norms])).float()
    return torch.sqrt(sum(n * n for n in norms)).float()


# elements per slice of the in-place update: bounds its fp32 temporaries
# (a 7B-width w1 leaf of 8 layers is 721 M elements)
_SLICE = 1 << 25


def _slices(p):
    """Views along the leading axis covering p in pieces of about _SLICE
    elements (the update is elementwise, so the values do not change)."""
    if p.dim() == 0:
        return [slice(None)]
    step = max(1, _SLICE // max(p[0].numel(), 1))
    return [slice(i, i + step) for i in range(0, p.shape[0], step)]


def count_zeros(grads) -> torch.Tensor:
    """Zero entries over every leaf (JAX :56-59)."""
    return sum((g == 0.0).sum() for g in tree_leaves(grads))


def _check_tcfg(tcfg: TrainConfig):
    if tcfg.optimizer not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer {tcfg.optimizer}")


def get_grad_scaler(tcfg: TrainConfig):
    """The fp16 loss scaler, None otherwise (JAX :62-80): constant when
    `loss_scale` is set, else dynamic."""
    if not tcfg.fp16:
        return None
    from megatron_llm_tpu_torch.optimizer.grad_scaler import (
        ConstantGradScaler,
        DynamicGradScaler,
    )

    if tcfg.loss_scale is not None:
        return ConstantGradScaler(tcfg.loss_scale)
    return DynamicGradScaler(initial_scale=tcfg.initial_loss_scale,
                             min_scale=tcfg.min_loss_scale,
                             growth_interval=tcfg.loss_scale_window,
                             hysteresis=tcfg.hysteresis)


def init_optimizer_state(params, tcfg: TrainConfig,
                         device=None) -> OptimizerState:
    """Zero moments shaped as `params`, on their device (or `device`)."""
    _check_tcfg(tcfg)

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device if device is None else device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    scaler = get_grad_scaler(tcfg)
    scaler_state = scaler.init_state(dev) if scaler is not None else None
    if tcfg.optimizer == "adam":
        return OptimizerState(step=step, m=tree_map(zeros, params),
                              v=tree_map(zeros, params), scaler=scaler_state)
    return OptimizerState(step=step, m=tree_map(zeros, params), v=None,
                          scaler=scaler_state)


@torch.no_grad()
def optimizer_step(params, grads, state: OptimizerState, tcfg: TrainConfig,
                   lr, weight_decay=None, found_inf=None, scaler=None,
                   reduce_fn=None, any_rank=None
                   ) -> Tuple[Any, OptimizerState, dict]:
    """One update (JAX :100-210), in place; returns (params, state, stats)
    with stats["grad_norm"] (fp32) and stats["skipped"] (int32) as 0-d
    tensors on the card. With `scaler` (fp16) the grads arrive unscaled;
    a non-finite grad norm is the overflow that updates the scaler's
    state, and stats["loss_scale"] is the scale this step used.

    Across ranks `params`, `grads` and the state's moments are this
    rank's pieces (tensor-parallel slices, ZeRO-1 blocks), `reduce_fn`
    sums per-leaf partials over the model (the gradient norm, the zero
    count, the params norm) and `any_rank` ORs flags over the world, so
    every rank skips the same steps and its scaler sees the same
    overflow."""
    _check_tcfg(tcfg)
    wd = tcfg.weight_decay if weight_decay is None else weight_decay
    lr = torch.as_tensor(lr, dtype=torch.float32)
    wd = torch.as_tensor(wd, dtype=torch.float32)
    p_leaves = tree_leaves(params)
    g_leaves = [g.float() for g in tree_leaves(grads)]
    dev = p_leaves[0].device
    lr, wd = lr.to(dev), wd.to(dev)

    grad_norm = global_grad_norm(g_leaves, reduce_fn)
    overflow = ~torch.isfinite(grad_norm)
    gate = found_inf
    if any_rank is not None:
        flags = any_rank(torch.stack([
            overflow, torch.zeros_like(overflow) if found_inf is None
            else found_inf.reshape(())]))
        overflow = flags[0]
        gate = None if found_inf is None else flags[1]
    finite = ~overflow
    if gate is not None:
        # the caller's skip gate (the loss watchdog) skips the update
        # only: a spike of finite gradients is no fp16 overflow
        finite = finite & ~gate
    new_scaler_state = state.scaler
    if scaler is not None:
        new_scaler_state = scaler.update(state.scaler, overflow)
    coeff = torch.clamp(tcfg.clip_grad / (grad_norm + 1e-6), max=1.0) \
        if tcfg.clip_grad > 0.0 else None
    num_zeros = torch.zeros((), dtype=torch.int64, device=dev)

    step = state.step + 1
    m_leaves = tree_leaves(state.m)
    v_leaves = tree_leaves(state.v) if state.v is not None \
        else [None] * len(m_leaves)
    if tcfg.optimizer == "adam":
        b1, b2, eps = tcfg.adam_beta1, tcfg.adam_beta2, tcfg.adam_eps
        stepf = step.float()
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=dev) ** stepf
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=dev) ** stepf
    for p_full, g_full, m_full, v_full in zip(p_leaves, g_leaves, m_leaves,
                                              v_leaves):
        # 1-D params (norm scales, biases) are never decayed
        wd_p = wd if p_full.dim() >= 2 else 0.0
        for sl in _slices(p_full):
            p, g, m = p_full[sl], g_full[sl], m_full[sl]
            if coeff is not None:
                g = g * coeff
            if tcfg.log_num_zeros_in_grad:
                num_zeros += count_zeros(g)
            if tcfg.optimizer == "adam":
                v = v_full[sl]
                new_m = b1 * m + (1 - b1) * g
                new_v = b2 * v + (1 - b2) * g.square()
                u = (new_m / bc1) / (torch.sqrt(new_v / bc2) + eps)
                p32 = p.float()
                new_p = (p32 - lr * (u + wd_p * p32)).to(p.dtype)
                v.copy_(torch.where(finite, new_v, v))
            else:  # sgd with momentum
                new_m = tcfg.sgd_momentum * m + g + wd_p * p.float()
                new_p = (p.float() - lr * new_m).to(p.dtype)
            p.copy_(torch.where(finite, new_p, p))
            m.copy_(torch.where(finite, new_m, m))
    state.step.copy_(torch.where(finite, step, state.step))

    stats = {"grad_norm": grad_norm,
             "skipped": (~finite).to(torch.int32)}
    if scaler is not None:
        stats["loss_scale"] = scaler.scale(state.scaler)
        state = state._replace(scaler=new_scaler_state)
    if tcfg.log_num_zeros_in_grad:
        stats["num_zeros"] = num_zeros if reduce_fn is None \
            else reduce_fn([num_zeros]).to(torch.int64)
    if tcfg.log_params_norm:
        stats["params_norm"] = global_grad_norm(p_leaves, reduce_fn)
    return params, state, stats
