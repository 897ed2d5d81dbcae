"""PyTorch port, tensor and sequence parallelism against the JAX package.

The same tiny Llama weights (fp32, 2 layers, h 64, 8 heads) go through
the JAX package at tp 2 and tp 4 with and without sequence parallelism
on its virtual CPU mesh (tests/test_tensor_parallel.py:90-160's set-up)
and through the port's ranks at the same layouts, four gloo CPU
processes (utils/virtual_mesh.spawn_cpu_group), MHA (8 KV groups) and
GQA (2 groups, qpk 4):

- the loss within rtol 1e-5 / atol 1e-6 of the JAX package's at the
  same layout and of the port at tp 1;
- the gathered gradient tree within `_assert_trees_close`'s rtol 1e-4 /
  atol 1e-5 of both;
- `shard_params` then `gather_params` gives the tree back bit for bit,
  and a rank's slice is the JAX `NamedSharding` shard of its device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from megatron_llm_tpu.config import tiny_config as jax_tiny_config
from megatron_llm_tpu.models import LlamaModel as JaxLlama
from megatron_llm_tpu.parallel.mesh import destroy_parallel as jax_destroy
from megatron_llm_tpu.parallel.mesh import (
    initialize_parallel as jax_initialize,
)
from megatron_llm_tpu.parallel.sharding import param_shardings
from megatron_llm_tpu_torch.config import falcon_config
from megatron_llm_tpu_torch.models import LlamaModel
from megatron_llm_tpu_torch.parallel.sharding import check_tp
from megatron_llm_tpu_torch.utils.virtual_mesh import spawn_cpu_group

torch.set_num_threads(1)

# (kv groups, tp, sequence parallel, port recompute policy)
CASES = [(8, 2, False, "none"), (8, 2, True, "selective"),
         (8, 4, False, "full"), (8, 4, True, "none"),
         (2, 2, False, "none"), (2, 2, True, "full")]
IDS = [f"{'mha' if kv == 8 else 'gqa'}-tp{tp}{'-sp' if sp else ''}"
       for kv, tp, sp, _ in CASES]


def _jax_cfg(kv):
    return jax_tiny_config(num_layers=2, hidden_size=64, num_attention_heads=8,
                           num_attention_heads_kv=kv, ffn_hidden_size=128,
                           seq_length=32, max_position_embeddings=32,
                           padded_vocab_size=256, compute_dtype=jnp.float32,
                           params_dtype=jnp.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def results():
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, 256, (4, 32)).astype(np.int64)
    labels = rs.randint(0, 256, (4, 32)).astype(np.int64)
    jt, jl = jnp.asarray(tokens, jnp.int32), jnp.asarray(labels, jnp.int32)
    params, jax_out = {}, {}
    for kv, seed in ((8, 0), (2, 1)):
        model = JaxLlama(_jax_cfg(kv))
        p = model.init(jax.random.key(seed))
        params[kv] = jax.tree.map(np.asarray, p)
        fn = jax.jit(jax.value_and_grad(model.loss))
        loss, grads = fn(p, jt, jl)
        jax_out[(kv, 1, False)] = (float(loss), _flat(grads), None)
        for _, tp, sp, _ in [c for c in CASES if c[0] == kv]:
            ctx = jax_initialize(dp=1, pp=1, tp=tp, sequence_parallel=sp,
                                 devices=jax.devices()[:tp])
            try:
                sharded = jax.device_put(p, param_shardings(ctx, model.cfg,
                                                            p))
                loss, grads = fn(sharded, jt, jl)
                shards = {name: {s.device: np.asarray(s.data)
                                 for s in a.addressable_shards}
                          for name, a in _flat_arrays(sharded).items()}
                jax_out[(kv, tp, sp)] = (float(loss), _flat(grads),
                                         (shards, jax.devices()[:tp]))
            finally:
                jax_destroy()
    port = spawn_cpu_group(4, torch_ranks.tp_loss_and_grads, CASES, params,
                           tokens, labels, timeout_s=240)
    # the port at tp 1, in this process
    port_tp1 = {}
    for kv in (8, 2):
        model = LlamaModel(torch_ranks.model_cfg(kv), device="cpu")
        p = {k: v for k, v in torch_ranks._t(params[kv]).items()}
        for leaf in jax.tree.leaves(p):
            leaf.requires_grad_(True)
        loss = model.loss(p, torch.from_numpy(tokens),
                          torch.from_numpy(labels))
        loss.backward()
        port_tp1[kv] = (float(loss.detach()), _flat(jax.tree.map(
            lambda x: x.grad.numpy(), p)))
    return {"params": params, "jax": jax_out, "port": port,
            "port_tp1": port_tp1}


def _flat_arrays(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_arrays(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _assert_trees_close(a, b, rtol=1e-4, atol=1e-5):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k], np.float32),
                                   np.asarray(b[k], np.float32), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_loss_matches_jax_at_the_same_layout(results, i):
    kv, tp, sp, _ = CASES[i]
    port = results["port"][0][i]["loss"]
    np.testing.assert_allclose(port, results["jax"][(kv, tp, sp)][0],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port, results["port_tp1"][kv][0], rtol=1e-5,
                               atol=1e-6)
    # every rank computes the same loss
    assert len({r[i]["loss"] for r in results["port"]}) == 1


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_grads_match_jax_at_the_same_layout(results, i):
    kv, tp, sp, _ = CASES[i]
    port = _flat(results["port"][0][i]["grads"])
    _assert_trees_close(port, results["jax"][(kv, tp, sp)][1])
    _assert_trees_close(port, results["port_tp1"][kv][1])


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_shard_then_gather_is_the_identity(results, i):
    kv = CASES[i][0]
    full = _flat(results["params"][kv])
    for rank in results["port"]:
        back = _flat(rank[i]["back"])
        assert set(back) == set(full)
        for k in full:
            np.testing.assert_array_equal(back[k], full[k], err_msg=k)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_rank_slice_is_the_named_sharding_shard(results, i):
    """Rank r's slice of each leaf is the JAX shard on the mesh's device
    at tp coordinate r (dp ranks hold the same slices)."""
    kv, tp, sp, _ = CASES[i]
    shards, devices = results["jax"][(kv, tp, sp)][2]
    for rank in results["port"]:
        mine = _flat(rank[i]["shards"])
        dev = devices[rank[i]["tp_rank"]]
        for k, v in mine.items():
            np.testing.assert_array_equal(v, shards[k][dev], err_msg=k)


def test_falcon_single_kv_group_cannot_split():
    """Falcon-7B has one KV group: tp 2 cannot give each rank whole
    groups of the grouped qkv layout, and says so."""
    with pytest.raises(ValueError, match="query groups"):
        check_tp(falcon_config(7, num_layers=1), 2)
    check_tp(falcon_config(40, num_layers=1), 8)
