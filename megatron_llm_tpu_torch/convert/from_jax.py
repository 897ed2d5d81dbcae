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
"""

from __future__ import annotations

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
