"""PyTorch port, flash attention (K4-K6): the plain versions and the
autograd path against the JAX package on the CPU.

The port's `flash_attention` / `flash_attention_with_lse` on CPU tensors
run the plain forward with lse and the plain FlashAttention-2 backward
(p recomputed from the saved lse), through the same autograd Functions
that launch K4-K6 on the card. They are held in fp32 within 1e-5 against
the JAX Pallas kernels under the interpreter (`jax.vjp` for the
gradients, the lse cotangent included; blocks of 32 so the online softmax
runs over several key blocks) and against the JAX plain references, over
MHA, GQA and MQA, causal and full. The kernels themselves run only on a
card: tests/test_torch_kernels_cuda.py holds them against these plain
versions there.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu_torch.ops import flash_attention as fa
from torch_parity import close, t

# the module (megatron_llm_tpu.ops re-exports the function under its name)
jfa = importlib.import_module("megatron_llm_tpu.ops.flash_attention")
TOL = 1e-5


def _inputs(b, s, g, qpk, d, t_len=None, seed=0):
    rs = np.random.RandomState(seed)
    t_len = s if t_len is None else t_len
    q = rs.randn(b, s, g, qpk, d).astype(np.float32)
    k = rs.randn(b, t_len, g, d).astype(np.float32)
    v = rs.randn(b, t_len, g, d).astype(np.float32)
    do = rs.randn(b, s, g, qpk, d).astype(np.float32)
    return q, k, v, do


def _port_grads(fn, q, k, v, cts):
    qt, kt, vt = (t(x).requires_grad_(True) for x in (q, k, v))
    out = fn(qt, kt, vt)
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(outs, tuple(t(c) for c in cts))
    return ([o.detach().numpy() for o in outs],
            [x.grad.numpy() for x in (qt, kt, vt)])


def _jax_grads(fn, q, k, v, cts):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    outs = out if isinstance(out, tuple) else (out,)
    cts = tuple(jnp.asarray(c) for c in cts)
    grads = vjp(cts if isinstance(out, tuple) else cts[0])
    return [np.asarray(o) for o in outs], [np.asarray(x) for x in grads]


def _compare(port, ref, msg):
    (po, pg), (ro, rg) = port, ref
    for a, b in zip(po, ro):
        close(a, b, TOL, f"{msg} out")
    for name, a, b in zip("qkv", pg, rg):
        close(a, b, TOL, f"{msg} d{name}")


# the Pallas kernels under the interpreter: three cases, s <= 128, b 1
@pytest.mark.parametrize("g,qpk,causal,with_lse", [
    (4, 1, True, False),    # MHA, causal
    (2, 2, True, True),     # GQA, causal, with lse and a nonzero dlse
    (1, 4, False, False),   # MQA, full
], ids=["mha_causal", "gqa_causal_lse", "mqa_full"])
def test_flash_matches_jax_pallas_kernels(g, qpk, causal, with_lse):
    q, k, v, do = _inputs(1, 128, g, qpk, 128, seed=g + qpk)
    kw = dict(causal=causal, use_pallas=True, interpret=True, block_q=32,
              block_k=32)
    if with_lse:
        dlse = np.random.RandomState(9).randn(1, 128, g, qpk) \
            .astype(np.float32)
        port = _port_grads(
            lambda a, b, c: fa.flash_attention_with_lse(a, b, c, causal),
            q, k, v, (do, dlse))
        ref = _jax_grads(
            lambda a, b, c: jfa.flash_attention_with_lse(a, b, c, **kw),
            q, k, v, (do, dlse))
    else:
        port = _port_grads(
            lambda a, b, c: fa.flash_attention(a, b, c, causal),
            q, k, v, (do,))
        ref = _jax_grads(
            lambda a, b, c: jfa.flash_attention(a, b, c, **kw), q, k, v,
            (do,))
    _compare(port, ref, f"g{g} qpk{qpk} causal={causal}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("g,qpk", [(4, 1), (2, 3), (1, 6)],
                         ids=["mha", "gqa", "mqa"])
def test_flash_matches_jax_reference(g, qpk, causal):
    """Against the JAX plain path (`_xla_reference`, differentiated by
    autodiff) at a ragged shape the Pallas gate would refuse (s 37,
    d 40)."""
    q, k, v, do = _inputs(2, 37, g, qpk, 40, seed=qpk)
    port = _port_grads(lambda a, b, c: fa.flash_attention(a, b, c, causal),
                       q, k, v, (do,))
    ref = _jax_grads(lambda a, b, c: jfa._xla_reference(a, b, c, causal),
                     q, k, v, (do,))
    _compare(port, ref, "xla reference")


def test_flash_with_lse_matches_jax_reference_full_attention():
    """The lse output and its cotangent against JAX autodiff of
    `_xla_reference_with_lse`, with t != s (full attention)."""
    q, k, v, do = _inputs(2, 24, 2, 2, 32, t_len=40, seed=3)
    dlse = np.random.RandomState(4).randn(2, 24, 2, 2).astype(np.float32)
    port = _port_grads(
        lambda a, b, c: fa.flash_attention_with_lse(a, b, c, False),
        q, k, v, (do, dlse))
    ref = _jax_grads(
        lambda a, b, c: jfa._xla_reference_with_lse(a, b, c, False),
        q, k, v, (do, dlse))
    _compare(port, ref, "with lse")


def test_plain_versions_match_jax_plain_versions():
    q, k, v, _ = _inputs(1, 16, 2, 2, 16, seed=6)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    for causal in (True, False):
        close(fa._xla_reference(t(q), t(k), t(v), causal).numpy(),
              jfa._xla_reference(jq, jk, jv, causal), TOL)
        o, lse = fa._xla_reference_with_lse(t(q), t(k), t(v), causal)
        jo, jl = jfa._xla_reference_with_lse(jq, jk, jv, causal)
        close(o.numpy(), jo, TOL)
        close(lse.numpy(), jl, TOL)


def test_lse_row_layout_is_the_kernel_abi():
    """(b*g, s*qpk, 1) rows with the head fastest, both ways, as JAX
    `_lse_rows_to_bsgq` / `_lse_bsgq_to_rows`."""
    lse = np.random.RandomState(1).randn(2, 5, 3, 4).astype(np.float32)
    rows = fa._lse_bsgq_to_rows(t(lse), 2, 5, 3, 4)
    close(rows.numpy(), jfa._lse_bsgq_to_rows(jnp.asarray(lse), 2, 5, 3, 4),
          0)
    close(fa._lse_rows_to_bsgq(rows, 2, 5, 3, 4).numpy(), lse, 0)


def test_bf16_plain_cast_points():
    """bf16 inputs keep their dtype through the plain forward and
    backward (p to v's dtype before PV; ds and p to the operands' dtypes
    before the gradient products), within bf16 rounding of fp32."""
    q, k, v, do = _inputs(1, 32, 2, 2, 64, seed=8)
    bf = torch.bfloat16
    qt, kt, vt = (t(x, bf).requires_grad_(True) for x in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, True)
    o.backward(t(do, bf))
    assert o.dtype == bf and all(x.grad.dtype == bf for x in (qt, kt, vt))
    ref = _port_grads(lambda a, b, c: fa.flash_attention(a, b, c, True),
                      *(t(x, bf).float().numpy() for x in (q, k, v)),
                      (t(do, bf).float().numpy(),))
    close(o.float().detach().numpy(), ref[0][0], 2e-2)
    for got, want in zip((qt.grad, kt.grad, vt.grad), ref[1]):
        scale = np.abs(want).max()
        close(got.float().numpy() / scale, want / scale, 2e-2)


def test_cpu_path_counts_no_launch():
    q, k, v, do = _inputs(1, 8, 1, 1, 8)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    _port_grads(lambda a, b, c: fa.flash_attention(a, b, c), q, k, v, (do,))
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == before
