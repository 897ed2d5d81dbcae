"""PyTorch port, the vocab-parallel cross entropy against the JAX
package's explicit shard_map path (`vocab_parallel_cross_entropy(...,
explicit=True)`, parallel/cross_entropy.py:53-106): logits split over
the vocabulary on tp 2 and tp 4 ranks (gloo CPU processes) and over the
JAX package's virtual CPU mesh, with and without label smoothing; the
per-token losses and the gradient of a weighted sum, gathered over the
shards, within rtol 1e-6 / atol 1e-6
(fp32: a loss near 15 is 1e-6 to the ulp). At tp 1 the port's form is its plain
`cross_entropy`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from megatron_llm_tpu.parallel.cross_entropy import (
    vocab_parallel_cross_entropy as jax_vp_ce,
)
from megatron_llm_tpu.parallel.mesh import destroy_parallel as jax_destroy
from megatron_llm_tpu.parallel.mesh import (
    initialize_parallel as jax_initialize,
)
from megatron_llm_tpu_torch.parallel.cross_entropy import (
    cross_entropy,
    vocab_parallel_cross_entropy,
)
from megatron_llm_tpu_torch.utils.virtual_mesh import spawn_cpu_group

torch.set_num_threads(1)

CASES = [(2, 0.0), (2, 0.1), (4, 0.0), (4, 0.1)]
IDS = [f"tp{tp}-ls{ls}" for tp, ls in CASES]


@pytest.fixture(scope="module")
def results():
    rs = np.random.RandomState(3)
    logits = (rs.randn(4, 16, 256) * 3).astype(np.float32)
    targets = rs.randint(0, 256, (4, 16)).astype(np.int64)
    weights = rs.rand(4, 16).astype(np.float32)
    jax_out = {}
    for tp, ls in CASES:
        jax_initialize(dp=1, pp=1, tp=tp, devices=jax.devices()[:tp])
        try:
            def f(x, ls=ls):
                loss = jax_vp_ce(x, jnp.asarray(targets, jnp.int32), ls,
                                 explicit=True)
                return jnp.sum(loss * weights), loss

            (_, loss), grad = jax.value_and_grad(f, has_aux=True)(
                jnp.asarray(logits))
            jax_out[(tp, ls)] = (np.asarray(loss), np.asarray(grad))
        finally:
            jax_destroy()
    port = spawn_cpu_group(4, torch_ranks.vocab_ce, logits, targets,
                           weights, CASES, timeout_s=120)
    return {"logits": logits, "targets": targets, "jax": jax_out,
            "port": port}


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_losses_match_the_explicit_jax_path(results, i):
    want = results["jax"][CASES[i]][0]
    for rank in results["port"]:
        np.testing.assert_allclose(rank[i]["loss"], want, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_grads_match_the_explicit_jax_path(results, i):
    want = results["jax"][CASES[i]][1]
    for rank in results["port"]:
        np.testing.assert_allclose(rank[i]["grad"], want, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_tp1_is_the_plain_cross_entropy(results, ls):
    x = torch.from_numpy(results["logits"])
    t = torch.from_numpy(results["targets"])
    torch.testing.assert_close(vocab_parallel_cross_entropy(x, t, ls),
                               cross_entropy(x, t, ls), rtol=0, atol=0)
