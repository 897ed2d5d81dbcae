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


def _layout(x, layout):
    """A (b, g, T, d) cache in `layout`: as it is, or as (b, T, g, d)."""
    return x if layout == "gtd" else np.ascontiguousarray(x.swapaxes(1, 2))


def _jax_refs(q, k, v, length, layout):
    """JAX's Pallas decode kernel (interpreted, 32-wide blocks) and its XLA
    twin on the same cache."""
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(length))
    return (jax_decode_attention(*args, layout=layout, use_pallas=True,
                                 block_t=32, interpret=True),
            jax_xla_decode(*args, layout))


@pytest.mark.parametrize("layout", ["gtd", "tgd"])
@pytest.mark.parametrize("g,qpk", [(4, 1), (2, 2), (1, 8), (1, 71), (1, 128)],
                         ids=["mha", "gqa", "mqa8", "qpk71", "qpk128"])
def test_decode_plain_matches_pallas_kernel_and_xla(g, qpk, layout):
    """fp32, 1e-5: the port's plain decode against the JAX Pallas kernel
    (interpreted) and its XLA twin, at lengths that start, straddle and
    end the kernel's 32-wide cache blocks, in both cache layouts, up to
    the kernel's 128 folded rows."""
    T = 96
    q, k, v = _qkv(2, g, qpk, 128, T, seed=qpk)
    k, v = _layout(k, layout), _layout(v, layout)
    for length in (1, 31, 33, 96):
        got = dec.decode_attention(t(q), t(k), t(v), length,
                                   layout=layout).numpy()
        ref_kernel, ref_xla = _jax_refs(q, k, v, length, layout)
        close(got, ref_kernel, 1e-5, f"kernel length={length}")
        close(got, ref_xla, 1e-5, f"xla length={length}")


@pytest.mark.parametrize("layout", ["gtd", "tgd"])
@pytest.mark.parametrize("qpk", [1, 8, 71, 128])
def test_decode_plain_takes_a_tensor_length(qpk, layout):
    """`length` as a 0-d int32 tensor (the kernel reads it on the card, so
    one captured launch replays at any length): the same answer as the
    int, and as the JAX kernel (interpreted) and its XLA twin, 1e-5."""
    T = 64
    q, k, v = _qkv(2, 1, qpk, 128, T, seed=50 + qpk)
    k, v = _layout(k, layout), _layout(v, layout)
    for length in (1, 33, 64):
        n = torch.tensor(length, dtype=torch.int32)
        got = dec.decode_attention(t(q), t(k), t(v), n, layout=layout)
        np.testing.assert_array_equal(
            got.numpy(), dec.decode_attention(t(q), t(k), t(v), length,
                                              layout=layout).numpy())
        ref_kernel, ref_xla = _jax_refs(q, k, v, length, layout)
        close(got.numpy(), ref_kernel, 1e-5, f"kernel length={length}")
        close(got.numpy(), ref_xla, 1e-5, f"xla length={length}")


def test_decode_tgd_reads_a_stacked_cache_slice_in_place():
    """One layer's (b, T, g, d) slice of a stacked (L, b, T, g, d) cache,
    taken as a view: the plain version reads it where it lies (no copy)
    and equals the JAX kernel (interpreted) and its XLA twin on the same
    slice, 1e-5."""
    rs = np.random.RandomState(11)
    L, b, T, g, qpk, d = 3, 2, 64, 2, 4, 128
    ks = rs.randn(L, b, T, g, d).astype(np.float32)
    vs = rs.randn(L, b, T, g, d).astype(np.float32)
    q = rs.randn(b, 1, g, qpk, d).astype(np.float32)
    kst, vst = t(ks), t(vs)
    k1, v1 = kst[1], vst[1]
    assert k1._base is kst and k1.data_ptr() == kst.data_ptr() \
        + b * T * g * d * kst.element_size()
    got = dec.decode_attention(t(q), k1, v1, 40, layout="tgd").numpy()
    ref_kernel, ref_xla = _jax_refs(q, ks[1], vs[1], 40, "tgd")
    close(got, ref_kernel, 1e-5, "kernel")
    close(got, ref_xla, 1e-5, "xla")


def test_decode_layout_is_checked():
    q, k, v = _qkv(1, 1, 1, 8, 4)
    with pytest.raises(ValueError, match="layout"):
        dec.decode_attention(t(q), t(k), t(v), 3, layout="bgtd")


@pytest.mark.parametrize("dtype,qpk,design", [
    (torch.bfloat16, 1, "cuda_cores"), (torch.bfloat16, 2, "cuda_cores"),
    (torch.bfloat16, 4, "tensor_cores"), (torch.bfloat16, 8, "tensor_cores"),
    (torch.bfloat16, 71, "tensor_cores"), (torch.float32, 8, "cuda_cores"),
    (torch.float32, 128, "cuda_cores")])
def test_decode_design_reads_dtype_and_qpk(dtype, qpk, design):
    """K1's tensor-core design takes bf16 at qpk >= 4; fp32 (every product
    in fp32) and bf16 at fewer heads a group run on CUDA cores."""
    assert dec.decode_design(dtype, qpk) == design


def _check_args(qpk, layout="gtd", dtype=torch.float32, d=16):
    """The operands `_check` inspects, on the CPU (it reads shapes, dtypes
    and strides only)."""
    q = torch.zeros(2, 1, 3, qpk, d, dtype=dtype)
    k = torch.zeros(2, 3, 40, d, dtype=dtype)
    if layout == "tgd":
        k = torch.zeros(4, 2, 40, 3, d, dtype=dtype)[1]  # a stacked slice
    return q, k, k.clone()


@pytest.mark.parametrize("layout", ["gtd", "tgd"])
@pytest.mark.parametrize("qpk", [1, 16, 17, 71, 128, 129])
def test_decode_kernel_takes_qpk_up_to_128_in_both_layouts(qpk, layout):
    """The kernel's checks: 1..128 heads a group (MAX_DECODE_ROWS), either
    layout (a tgd cache as a strided slice of a stacked one), a host length
    within the cache or a 0-d int32 tensor; the tensor-core design only
    for bf16."""
    q, k, v = _check_args(qpk, layout)
    length = torch.tensor(7, dtype=torch.int32)
    if qpk > 128:
        with pytest.raises(ValueError, match="qpk"):
            dec._check(q, k, v, 7, layout, "cuda_cores")
        return
    for n in (7, length):
        dec._check(q, k, v, n, layout, "cuda_cores")
    with pytest.raises(ValueError, match="length"):
        dec._check(q, k, v, 41, layout, "cuda_cores")
    with pytest.raises(ValueError, match="length"):
        dec._check(q, k, v, length.long(), layout, "cuda_cores")
    with pytest.raises(ValueError, match="design"):
        dec._check(q, k, v, 7, layout, "tensor_cores")
    other = "tgd" if layout == "gtd" else "gtd"
    with pytest.raises(ValueError, match="layout"):
        dec._check(q, k, v, 7, other, "cuda_cores")


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


# ---------------------------------------------------------------------------
# K2 with rstd and K3: RMSNorm through autograd
# ---------------------------------------------------------------------------


def _rms_vjp_port(x, scale, g, eps=1e-5):
    xt = t(x).requires_grad_(True)
    st = t(scale).requires_grad_(True)
    out = rms.fused_rms_norm(xt, st, eps)
    out.backward(t(g))
    return out.detach().numpy(), xt.grad.numpy(), st.grad.numpy()


@pytest.mark.parametrize("shape", [(16, 256), (2, 8, 384)],
                         ids=["n16", "b2s8"])
def test_rmsnorm_backward_matches_pallas_kernel(shape):
    """fp32, 1e-5: `_FusedRMSNorm` on the CPU (plain forward with rstd,
    the plain backward of the Pallas kernel's formulas) against
    jax.vjp of the Pallas RMSNorm forward and backward under the
    interpreter, and against autodiff of the JAX plain norm."""
    import jax

    rs = np.random.RandomState(len(shape))
    x = rs.randn(*shape).astype(np.float32)
    scale = (1.0 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    out, dx, ds = _rms_vjp_port(x, scale, g)
    for fn in (lambda a, b: jax_fused_rms_norm(a, b, 1e-5, use_pallas=True,
                                               interpret=True),
               lambda a, b: jax_rms_norm(a, b, 1e-5)):
        ref_out, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(scale))
        ref_dx, ref_ds = vjp(jnp.asarray(g))
        close(out, ref_out, 1e-5)
        close(dx, ref_dx, 1e-5)
        close(ds, ref_ds, 1e-5 * np.abs(np.asarray(ref_ds)).max())


def test_rmsnorm_plain_backward_formulas():
    """`_plain_bwd` from `_plain_fwd`'s rstd equals torch autodiff of the
    plain `rms_norm` in fp32, and its rstd equals 1/sqrt(mean(x^2)+eps)."""
    rs = np.random.RandomState(7)
    x = rs.randn(5, 40).astype(np.float32)
    scale = rs.randn(40).astype(np.float32)
    g = rs.randn(5, 40).astype(np.float32)
    out, rstd = rms._plain_fwd(t(x), t(scale), 1e-5)
    close(rstd.numpy()[:, 0],
          1 / np.sqrt((x.astype(np.float64) ** 2).mean(-1) + 1e-5), 1e-6)
    dx, ds = rms._plain_bwd(t(x), t(scale), rstd, t(g))
    xt = t(x).requires_grad_(True)
    st = t(scale).requires_grad_(True)
    rms.rms_norm(xt, st, 1e-5).backward(t(g))
    close(out.numpy(), rms.rms_norm(t(x), t(scale), 1e-5).numpy(), 0)
    close(dx.numpy(), xt.grad.numpy(), 1e-5)
    close(ds.numpy(), st.grad.numpy(), 1e-5)


def test_rmsnorm_autograd_path_only_where_autograd_records():
    """Serving (no grad) takes the forward without rstd; a CPU tensor
    launches neither kernel."""
    x = t(np.random.RandomState(2).randn(3, 16).astype(np.float32))
    s = torch.ones(16)
    k2, k3 = rms.fused_rms_norm.launches, rms.rms_norm_bwd.launches
    with torch.no_grad():
        assert rms.fused_rms_norm(x, s.requires_grad_(True)).grad_fn is None
    out = rms.fused_rms_norm(x.requires_grad_(True), s)
    assert type(out.grad_fn).__name__ == "_FusedRMSNormBackward"
    out.sum().backward()
    assert (rms.fused_rms_norm.launches, rms.rms_norm_bwd.launches) == (k2, k3)
