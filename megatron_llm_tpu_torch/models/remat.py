"""Activation-recompute policies over named save points (port of
models/remat.py).

The JAX package tags the expensive matmul outputs with
`checkpoint_name` where they are defined, and each `jax.checkpoint`
policy decides which names survive to the backward. Here the same
ladder runs on `torch.utils.checkpoint` in its non-reentrant form:

- "full": checkpoint the layer with no policy, keeping only what crosses
  its boundary and recomputing the rest in the backward (+~1/3 FLOPs);
- "selective": keep the products named in SELECTIVE_SAVE_NAMES, so the
  backward recomputes only elementwise ops (norms, GLU, RoPE, residual
  adds, dropout masks) and never a GEMM or the flash forward K4;
- "save_dots": keep every product of the layer, named or not;
- "offload": the selective set, parked in pinned host memory and brought
  back in the backward: device memory like "full", FLOPs like
  "selective", paid in host copies;
- "none": no checkpoint wrapper.

How a name reaches the recompute. torch's recompute replays the whole
layer, and the autograd nodes it builds must save their tensors in the
forward's order; so a kept product is not skipped in Python but answered
below autograd, by a dispatch mode. `tag(*names)` is a context manager
around the code that computes a save point: it sets the names the
products inside it carry. While a checkpointed layer runs forward, the
`_Keep` mode stores the output of every product (`aten.mm`, `addmm`,
`bmm`, and the flash forward, which ops/flash_attention.py registers as
the dispatcher op `megatron_llm_tpu_torch::flash_fwd` for this reason:
its ctypes launch is otherwise invisible) that the policy keeps, in
order; in the recompute the `_Replay` mode answers the same products, in
the same order, from that store, and runs every other op. The ops that
surround a product (the weight cast, views, a bias add) are recomputed,
as JAX recomputes the elementwise part of a named value. Under "offload"
the store holds pinned host copies, made on the layer's stream as each
product finishes and copied back as the recompute reaches it: the
offload is the store, so no saved-tensor hook is needed beside it.

JAX's `tag(x, name)` names a value; the port's names the computation of
it, because the decision to keep a product is taken as it runs. "mlp_act"
names elementwise work only, so no policy keeps anything under it, as in
JAX. "mlp_out" is a layer's last product: torch's recompute stops once
the last tensor the backward saves is packed, which comes before it
unless a dropout mask is drawn after it, so its kept output is read only
under hidden dropout (JAX's compiler drops that residual instead).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from megatron_llm_tpu_torch.config import REMAT_POLICIES

# every tagged save point
CHECKPOINT_NAMES = (
    "qkv_proj",
    "attn_ctx",
    "flash_lse",
    "attn_dense",
    "mlp_pre_act",
    "mlp_act",
    "mlp_out",
)

# what "selective" keeps: the matmul outputs and the flash forward's lse
# rows, so the backward never runs K4 again; `mlp_act` is absent, being
# elementwise from `mlp_pre_act`
SELECTIVE_SAVE_NAMES = (
    "qkv_proj",
    "attn_ctx",
    "flash_lse",
    "attn_dense",
    "mlp_pre_act",
    "mlp_out",
)

# the offload policy ships the same set to pinned host memory
OFFLOAD_NAMES = SELECTIVE_SAVE_NAMES

# the products a policy can keep, by dispatcher name
PRODUCTS = ("aten::mm", "aten::addmm", "aten::bmm",
            "megatron_llm_tpu_torch::flash_fwd")

_names = contextvars.ContextVar("save_point", default=())


@contextlib.contextmanager
def tag(*names: str):
    """The products computed inside the block are the named save
    point(s)."""
    for name in names:
        if name not in CHECKPOINT_NAMES:
            raise ValueError(f"unknown save point {name!r}")
    token = _names.set(names)
    try:
        yield
    finally:
        _names.reset(token)


def _keeps(policy: str, func) -> bool:
    if func._schema.name not in PRODUCTS:
        return False
    if policy == "save_dots":
        return True
    names = _names.get()
    kept = OFFLOAD_NAMES if policy == "offload" else SELECTIVE_SAVE_NAMES
    return bool(names) and all(n in kept for n in names)


def _stash(out, offload: bool):
    """(whether `out` is a tuple, its tensors detached, or under offload
    as (pinned host copy, device) pairs)."""
    outs = out if isinstance(out, tuple) else (out,)
    if not offload:
        return isinstance(out, tuple), [t.detach() for t in outs]
    items = []
    for t in outs:
        host = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                           pin_memory=t.is_cuda)
        host.copy_(t, non_blocking=True)
        items.append((host, t.device))
    return isinstance(out, tuple), items


def _unstash(stashed, offload: bool):
    is_tuple, items = stashed
    if offload:
        items = [h.to(dev, non_blocking=True) for h, dev in items]
    return tuple(items) if is_tuple else items[0]


class _Keep(TorchDispatchMode):
    """The forward of a checkpointed call: every op runs; the outputs of
    the products the policy keeps are stored in order, with their save
    point names (`kept[i] = (names, stashed output)`)."""

    def __init__(self, policy: str, kept: collections.deque):
        super().__init__()
        self.policy, self.kept = policy, kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _keeps(self.policy, func):
            self.kept.append((_names.get(),
                              _stash(out, self.policy == "offload")))
        return out


class _Replay(TorchDispatchMode):
    """The recompute of the same call: the kept products are answered
    from the store, in the forward's order; every other op runs."""

    def __init__(self, policy: str, kept: collections.deque):
        super().__init__()
        self.policy, self.kept = policy, kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not _keeps(self.policy, func):
            return func(*args, **(kwargs or {}))
        if not self.kept:
            raise RuntimeError(f"recompute reached a kept {func} that the "
                               f"forward did not keep")
        names, stashed = self.kept.popleft()
        if names != _names.get():
            raise RuntimeError(f"recompute reached {_names.get()} where "
                               f"the forward kept {names}")
        return _unstash(stashed, self.policy == "offload")


def policy_contexts(policy: str):
    """(forward context, recompute context) of one checkpointed call
    under a named-save-point policy, sharing one store."""
    kept = collections.deque()
    return _Keep(policy, kept), _Replay(policy, kept)


def remat_wrap(fn, policy: str):
    """`fn` under the named policy: untouched for "none", a
    non-reentrant checkpoint for the others. Outside autograd (no_grad,
    inference) every policy is a plain call, as recompute has nothing to
    save there. No RNG state is replayed: the dropout masks are drawn
    from seeds the layer derives (models/dropout.py), so the recompute
    draws them again bit for bit."""
    if policy == "none":
        return fn
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy {policy!r}: expected one of "
                         f"{REMAT_POLICIES}")
    kw = {} if policy == "full" else {
        "context_fn": functools.partial(policy_contexts, policy)}

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    return wrapped
