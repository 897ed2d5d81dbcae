"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py):
the tiny GQA Llama of the serving drive, built once per process in both
packages on the same weights (JAX init -> numpy -> the port's bridge)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from megatron_llm_tpu.config import tiny_config as jax_tiny_config
from megatron_llm_tpu.models import LlamaModel as JaxLlama
from megatron_llm_tpu_torch.config import tiny_config as torch_tiny_config
from megatron_llm_tpu_torch.convert.from_jax import params_from_jax
from megatron_llm_tpu_torch.models import LlamaModel as TorchLlama

# six xdist workers share the machine's cores
torch.set_num_threads(1)

TINY = dict(hidden_size=512, num_attention_heads=4, num_attention_heads_kv=2,
            kv_channels=128, ffn_hidden_size=256)
# the JAX decode steps run the real Pallas kernel under the interpreter
JAX_KERNEL = dict(use_decode_attn=True, decode_attn_min_cache=0,
                  decode_attn_interpret=True)


def jax_cfg(**kw):
    return jax_tiny_config(**TINY, compute_dtype=jnp.float32, **kw)


def torch_cfg(**kw):
    return torch_tiny_config(**TINY, compute_dtype=torch.float32, **kw)


@functools.lru_cache(maxsize=None)
def tiny_pair(seed: int = 7, jax_kernel: bool = False, window=None,
              max_pos: int = 64):
    """(jax_model, jax_params, torch_model, torch_params) on shared
    weights; the torch side lives on the CPU. `window` sets
    attention_window_size, `max_pos` the rotary table's length."""
    kw = dict(attention_window_size=window, seq_length=max_pos,
              max_position_embeddings=max_pos)
    jm = JaxLlama(jax_cfg(**(JAX_KERNEL if jax_kernel else {}), **kw))
    jp = jm.init(jax.random.key(seed))
    tm = TorchLlama(torch_cfg(**kw), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


def t(x, dtype=None):
    """numpy -> CPU tensor."""
    out = torch.from_numpy(np.ascontiguousarray(x))
    return out if dtype is None else out.to(dtype)


def close(a, b, tol, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64),
                               rtol=0, atol=tol, err_msg=msg)

