"""Activation-recompute policies (port of models/remat.py).

The JAX package builds a ladder of `jax.checkpoint` policies over named
save points. Two rungs are ported, onto `torch.utils.checkpoint` in its
non-reentrant form:

- "none": no checkpoint wrapper;
- "full": checkpoint the layer, keeping only what crosses its boundary
  and recomputing the rest in the backward (+~1/3 FLOPs).

"selective", "save_dots" and "offload" raise ValueError naming a later
slice (ROADMAP.md A3): they keep named save points (or every matmul
output), and torch's selective checkpointing sees only aten ops, while
the ctypes-launched kernels of this port are opaque to it.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from megatron_llm_tpu_torch.config import REMAT_POLICIES


def remat_wrap(fn, policy: str):
    """`fn` under the named policy: untouched for "none", a non-reentrant
    checkpoint for "full"; the named-save-point policies raise when
    autograd records. Outside autograd (no_grad, inference) every policy
    is a plain call, as recompute has nothing to save there."""
    if policy == "none":
        return fn
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy {policy!r}: expected one of "
                         f"{REMAT_POLICIES}")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if policy != "full":
            raise ValueError(
                f"remat policy {policy!r} is not ported yet: it keeps named "
                f"save points, which torch's selective checkpointing cannot "
                f"see through the port's kernels (ROADMAP.md A3)")
        # the layers draw no random numbers: no RNG state to replay
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)

    return wrapped
