"""PyTorch port, kernel modules: decode attention (K1) and RMSNorm (K2).

On the CPU each module's plain version is held against the JAX module:
K1's against the real Pallas decode kernel under the interpreter and
against `_xla_decode`, K2's against the Pallas RMSNorm under the
interpreter and against `models/norms.rms_norm`. The kernels themselves
(CUDA C++ and Triton) run only on a card: tests/test_torch_kernels_cuda.py
holds them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.models.norms import rms_norm as jax_rms_norm
from megatron_llm_tpu.ops.decode_attention import (
    _xla_decode as jax_xla_decode,
    decode_attention as jax_decode_attention,
)
from megatron_llm_tpu.ops.rmsnorm import fused_rms_norm as jax_fused_rms_norm
from megatron_llm_tpu_torch.ops import decode_attention as dec
from megatron_llm_tpu_torch.ops import rmsnorm as rms
from torch_parity import close, t


def _qkv(b, g, qpk, d, T, dtype=np.float32, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, 1, g, qpk, d).astype(dtype)
    k = rs.randn(b, g, T, d).astype(dtype)
    v = rs.randn(b, g, T, d).astype(dtype)
    return q, k, v


# ---------------------------------------------------------------------------
# K1: decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g,qpk", [(4, 1), (2, 2), (1, 8)],
                         ids=["mha", "gqa", "mqa8"])
def test_decode_plain_matches_pallas_kernel_and_xla(g, qpk):
    """fp32, 1e-5: the port's plain decode against the JAX Pallas kernel
    (interpreted) and its XLA twin, at lengths that start, straddle and
    end the kernel's 32-wide cache blocks."""
    T = 96
    q, k, v = _qkv(2, g, qpk, 128, T, seed=qpk)
    for length in (1, 31, 33, 96):
        got = dec.decode_attention(t(q), t(k), t(v), length).numpy()
        ref_kernel = jax_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(length),
            layout="gtd", use_pallas=True, block_t=32, interpret=True)
        ref_xla = jax_xla_decode(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.int32(length), "gtd")
        close(got, ref_kernel, 1e-5, f"kernel length={length}")
        close(got, ref_xla, 1e-5, f"xla length={length}")


def test_decode_prefill_rows_are_causal():
    """s > 1 (a prefill chunk) takes `_xla_decode`: row r of the chunk
    attends through cache position length - s + r // qpk."""
    rs = np.random.RandomState(3)
    q = rs.randn(2, 5, 2, 2, 64).astype(np.float32)
    k = rs.randn(2, 2, 16, 64).astype(np.float32)
    v = rs.randn(2, 2, 16, 64).astype(np.float32)
    got = dec._xla_decode(t(q), t(k), t(v), 9).numpy()
    ref = jax_xla_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.int32(9), "gtd")
    close(got, ref, 1e-5)


def test_decode_plain_bf16_matches_xla():
    """bf16 on O(1) inputs: the same dense core in both packages, within
    2 bf16 ulps at |x| <= 4."""
    q, k, v = _qkv(2, 2, 2, 128, 64, seed=5)
    bf = torch.bfloat16
    got = dec.decode_attention(t(q, bf), t(k, bf), t(v, bf), 50)
    ref = jax_xla_decode(jnp.asarray(q, jnp.bfloat16),
                         jnp.asarray(k, jnp.bfloat16),
                         jnp.asarray(v, jnp.bfloat16), jnp.int32(50), "gtd")
    assert got.dtype == bf
    close(got.float().numpy(), np.asarray(ref, np.float32), 2 ** -5)


def test_decode_wrapper_counts_only_kernel_launches():
    """A CPU tensor runs the plain version and never counts a launch."""
    q, k, v = _qkv(1, 1, 1, 8, 4)
    before = dec.decode_attention.launches
    dec.decode_attention(t(q), t(k), t(v), 3)
    assert dec.decode_attention.launches == before


# ---------------------------------------------------------------------------
# K2: RMSNorm forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 5, 256], ids=["n8", "n5", "n256"])
def test_rmsnorm_plain_fp32_matches_pallas_and_xla(n):
    rs = np.random.RandomState(n)
    x = rs.randn(n, 256).astype(np.float32)
    scale = (1.0 + 0.1 * rs.randn(256)).astype(np.float32)
    got = rms.fused_rms_norm(t(x), t(scale), 1e-5).numpy()
    close(got, jax_rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5), 1e-6)
    ref_kernel = jax_fused_rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5,
                                    use_pallas=True, interpret=True)
    close(got, ref_kernel, 1e-6)


def test_rmsnorm_plain_bf16_cast_order():
    """bf16: normalise in fp32, cast, then scale in bf16 — within one bf16
    ulp of the JAX Pallas kernel (interpreted) and of the JAX plain norm."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, 8, 256).astype(np.float32)
    scale = (1.0 + 0.1 * rs.randn(256)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    sb = jnp.asarray(scale, jnp.bfloat16)
    got = rms.fused_rms_norm(t(x, torch.bfloat16), t(scale, torch.bfloat16),
                             1e-5).float().numpy()
    for ref in (jax_rms_norm(xb, sb, 1e-5),
                jax_fused_rms_norm(xb, sb, 1e-5, use_pallas=True,
                                   interpret=True)):
        ref = np.asarray(ref, np.float32)
        ulp = np.spacing(np.abs(ref).astype(np.float32)) * 2 ** 16
        assert np.all(np.abs(got - ref) <= ulp)
