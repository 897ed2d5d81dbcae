"""PyTorch port, ring attention (context parallelism) against the JAX
package's ring.

The same fp32 inputs, made from a numpy seed, go through the JAX
package's `make_ring_attention` / `ring_self_attention` on its virtual
CPU mesh and through the port's `ring_self_attention` in cp gloo CPU
ranks (utils/virtual_mesh.spawn_cpu_group), each rank holding its
contiguous sequence shard:

- cp 2 and cp 4, causal and full, (g, qpk) of (2, 2), (4, 1) and (1, 4):
  the output and dq, dk, dv of sum(o * cotangent) within 1e-5;
- the JAX ring once more with its real flash kernel under the Pallas
  interpreter (`use_pallas=True, interpret=True`, as
  tests/test_ring_attention.py:101 runs it), cp 2 causal;
- packed documents (`doc_start`, global indices, documents that
  straddle the shards) at cp 2 and cp 4 against the JAX masked ring.

On the CPU each hop runs the plain versions of K4-K6; the card runs the
kernels (tests/test_torch_kernels_cuda.py, chip_smoke.py's
`context_parallel` phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_cp_ranks as C
from conftest import kernel_interpret_mode
from megatron_llm_tpu.parallel.mesh import shard_map
from megatron_llm_tpu.parallel.ring_attention import (
    make_ring_attention,
    ring_self_attention,
)
from megatron_llm_tpu_torch.utils.virtual_mesh import spawn_cpu_group

torch.set_num_threads(1)

INTERPRET = kernel_interpret_mode()
B, S, D = 2, 32, 8
SHAPES = [(2, 2), (4, 1), (1, 4)]
# (cp, causal, g, qpk, docs, pallas): the cases of each group size
CASES = {
    cp: [(cp, causal, g, qpk, False, False) for causal in (True, False)
         for g, qpk in SHAPES] + [(cp, True, 2, 1, True, False)]
    for cp in (2, 4)}
CASES[2].append((2, True, 2, 1, False, True))


def _ids(cases):
    return [f"cp{c[0]}-{'causal' if c[1] else 'full'}-g{c[2]}q{c[3]}"
            + ("-docs" if c[4] else "") + ("-pallas" if c[5] else "")
            for c in cases]


def _inputs(case, seed):
    cp, causal, g, qpk, docs, pallas = case
    rs = np.random.RandomState(seed)
    b, s, d = (1, 128, 128) if pallas else (B, S, D)
    q = rs.randn(b, s, g, qpk, d).astype(np.float32)
    k = rs.randn(b, s, g, d).astype(np.float32)
    v = rs.randn(b, s, g, d).astype(np.float32)
    cot = rs.randn(b, s, g, qpk, d).astype(np.float32)
    ds = None
    if docs:
        # documents of 11, 9, 5 and 7 tokens in row 0 (eods at 10, 19,
        # 24), two in row 1: several cross a shard boundary
        ds = np.zeros((b, s), np.int32)
        for row, starts in ((0, (0, 11, 20, 25)), (1, (0, 14))):
            for a in starts:
                ds[row, a:] = a
    return q, k, v, cot, ds


def _mesh(cp):
    return Mesh(np.asarray(jax.devices()[:cp]), ("cp",))


def _jax_ring(case, q, k, v, cot, ds):
    cp, causal, *_, pallas = case
    if ds is None:
        ring = make_ring_attention(_mesh(cp), "cp", causal=causal,
                                   use_pallas=True if pallas else None,
                                   interpret=INTERPRET if pallas else False)
        fn = ring
        args = ()
    else:
        fn = shard_map(
            lambda q_, k_, v_, d_: ring_self_attention(
                q_, k_, v_, "cp", causal=True, doc_start=d_),
            mesh=_mesh(cp),
            in_specs=(P(None, "cp"), P(None, "cp"), P(None, "cp"),
                      P(None, "cp")),
            out_specs=P(None, "cp"), axis_names={"cp"})
        args = (jnp.asarray(ds),)

    def loss(q_, k_, v_):
        o = fn(q_, k_, v_, *args)
        return jnp.sum(o * cot), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(o)] + [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def results():
    inputs = {cp: [_inputs(c, i) for i, c in enumerate(CASES[cp])]
              for cp in CASES}
    jax_out = {cp: [_jax_ring(c, *x) for c, x in zip(CASES[cp], inputs[cp])]
               for cp in CASES}
    port = {cp: spawn_cpu_group(cp, C.ring, [
        (c[1], *x) for c, x in zip(CASES[cp], inputs[cp])], timeout_s=180)
        for cp in CASES}
    return jax_out, port


@pytest.mark.parametrize("cp,i", [(cp, i) for cp in CASES
                                  for i in range(len(CASES[cp]))],
                         ids=_ids(CASES[2] + CASES[4]))
def test_ring_matches_the_jax_ring(results, cp, i):
    jax_out, port = results
    for j, name in enumerate(("o", "dq", "dk", "dv")):
        got = np.concatenate([r[i][j] for r in port[cp]], axis=1)
        np.testing.assert_allclose(got, jax_out[cp][i][j], rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_ring_needs_equal_shards_and_causal_documents():
    from megatron_llm_tpu_torch.parallel.mesh import ParallelContext
    from megatron_llm_tpu_torch.parallel.ring_attention import (
        ring_self_attention as port_ring,
    )

    ctx = ParallelContext(cp=2)
    q = torch.zeros(1, 4, 1, 1, 8)
    k = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="causal"):
        port_ring(q, k, k, causal=False,
                  doc_start=torch.zeros(1, 4, dtype=torch.int32), ctx=ctx)
    with pytest.raises(ValueError, match="equal query and key"):
        port_ring(q, k[:, :2], k[:, :2], ctx=ctx)
    with pytest.raises(ValueError, match="parallel context"):
        port_ring(q, k, k)
