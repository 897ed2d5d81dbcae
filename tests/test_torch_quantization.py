"""PyTorch port, int8 quantization (ops/quantization.py) and the int8
serving engine against the JAX package on the CPU in fp32 (the oracles of
tests/test_quantization.py): `quantize_rows`, `quantize_weight`, the
decode tree's weight quantization and the quantizing scatter are bitwise
JAX's as its jitted steps compute them, zero rows included; the int8
`qdot` within 1e-5; the engine with int8 pools (alone, with int8
weights, with the prefix cache's copy-on-write, with whole-prompt
admission) gives the JAX engine's greedy token streams on the same
traffic, log-probs within 1e-5 and exactly equal page and prefix-cache
accounting and pool gauges."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.inference.engine import DecodeEngine as JaxEngine
from megatron_llm_tpu.ops import quantization as jq
from megatron_llm_tpu.ops.prefill_attention import (
    scatter_chunk_kv as jax_scatter,
)
from megatron_llm_tpu_torch.inference.engine import DecodeEngine
from megatron_llm_tpu_torch.ops import prefill_attention as pa
from megatron_llm_tpu_torch.ops import quantization as pq
from torch_parity import close, t, tiny_pair


def _data(shape, seed, axis):
    """Rows of mixed magnitude, two all-zero rows along `axis`, and a
    value on a rounding tie."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * rs.choice([1e-3, 1.0, 30.0], shape)).astype(
        np.float32)
    x = np.moveaxis(x, axis, -1).copy()
    flat = x.reshape(-1, x.shape[-1])
    flat[0] = 0.0
    flat[-1] = 0.0
    flat[1, :2] = [127.0, 0.5]  # scale 1: 0.5 rounds half to even, to 0
    return np.moveaxis(flat.reshape(x.shape), -1, axis).copy()


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("shape,axis", [((7, 2, 128), -1), ((64, 96), 0),
                                        ((3, 5, 4, 16), -1)])
def test_quantize_rows_bitwise(shape, axis):
    x = _data(shape, seed=len(shape), axis=axis)
    data, scale = pq.quantize_rows(t(x), axis)
    ref_data, ref_scale = jax.jit(jq.quantize_rows, static_argnums=1)(
        jnp.asarray(x), axis)
    assert data.dtype == torch.int8 and scale.dtype == torch.float32
    _eq(data.numpy(), ref_data)
    _eq(scale.numpy(), ref_scale)
    assert (np.asarray(scale) == 0).sum() >= 2  # the zero rows
    _eq(pq.dequantize_rows(data, scale, axis).numpy(),
        jq.dequantize_rows(ref_data, ref_scale, axis))
    # an eager JAX call divides by 127 instead: the data still agree
    _eq(data.numpy(), jq.quantize_rows(jnp.asarray(x), axis)[0])


def test_quantize_weight_and_int8_qdot():
    w = _data((64, 96), seed=1, axis=0)
    qw = pq.quantize_weight(t(w))
    ref = jax.jit(jq.quantize_weight)(jnp.asarray(w))
    assert pq.is_quantized_weight(qw) and not pq.is_quantized_weight(t(w))
    _eq(qw["int8_data"].numpy(), ref["int8_data"])
    _eq(qw["scale"].numpy(), ref["scale"])
    x = np.random.RandomState(2).randn(3, 5, 64).astype(np.float32)
    close(pq.qdot(t(x), qw, torch.float32),
          jq.qdot(jnp.asarray(x), ref, jnp.float32), 1e-5)
    close(pq.qdot(t(x), t(w), torch.float32), x @ w, 1e-5)
    with pytest.raises(ValueError, match="2D"):
        pq.quantize_weight(t(w[None]))


def test_decode_tree_quantization_bitwise():
    """`prepare_decode_params(quantize_int8=True)`: wqkv, wo, the flat
    GLU w1 and w2 of every layer bitwise JAX's int8 data and scales;
    the other leaves stay floating and equal."""
    jm, jp, tm, tp = tiny_pair()
    jd = jm.prepare_decode_params(jp, quantize_int8=True)
    td = tm.prepare_decode_params(tp, quantize_int8=True)
    for jl, tl in zip(jd["layers"], td["layers"]):
        for block, name in pq.QUANTIZED:
            for key in ("int8_data", "scale"):
                _eq(tl[block][name][key].numpy(), jl[block][name][key])
        for norm in ("input_norm", "post_attention_norm"):
            _eq(tl[norm]["scale"].numpy(), jl[norm]["scale"])
    assert len(td["layers"]) == len(jd["layers"])


def test_int8_scatter_bitwise():
    """The quantizing scatter: int8 data and scale pools equal JAX's bit
    for bit after a chunk with an all-zero token row, null page aside."""
    rs = np.random.RandomState(3)
    P, page, g, d = 9, 32, 2, 128
    kp, ks = jq.quantize_rows(jnp.asarray(rs.randn(P, page, g, d)
                                          .astype(np.float32)))
    vp, vs = jq.quantize_rows(jnp.asarray(rs.randn(P, page, g, d)
                                          .astype(np.float32)))
    pt = np.asarray([[3, 5], [8, 1], [2, 0]], np.int32)
    starts = np.asarray([0, 30, 7], np.int32)
    lens = np.asarray([6, 5, 0], np.int32)
    k_new = rs.randn(3, 6, g, d).astype(np.float32)
    v_new = rs.randn(3, 6, g, d).astype(np.float32)
    k_new[1, 2] = 0.0
    pools = [t(np.asarray(x).copy()) for x in (kp, vp, ks, vs)]
    out = pa.scatter_chunk_kv(t(k_new), t(v_new), pools[0], pools[1],
                              t(pt), t(starts), t(lens), pools[2], pools[3])
    ref = jax.jit(jax_scatter)(jnp.asarray(k_new), jnp.asarray(v_new), kp,
                               vp, jnp.asarray(pt), jnp.asarray(starts),
                               jnp.asarray(lens), k_scales=ks, v_scales=vs)
    assert all(a is b for a, b in zip(out, pools))  # in place
    for got, want in zip(out, ref):
        _eq(got.numpy()[1:], np.asarray(want)[1:])
    # the zero row: chunk 1's position 32 is page pt[1, 1] = 1, row 0
    assert (out[2][1, 0] == 0).all() and (out[0][1, 0] == 0).all()


# -- the int8 engine against the JAX engine ---------------------------------

BASE = dict(slots=2, page_size=16, max_context=64, max_queue=8,
            termination_id=None, vocab_size=256, prefill_chunk_tokens=8,
            kv_dtype="int8")
ACCOUNTING = ("serve_admitted", "serve_retired", "serve_steps",
              "serve_prefill_tokens", "serve_pages_free",
              "serve_pages_in_use", "serve_kv_dtype", "serve_kv_pool_bytes",
              "serve_kv_bytes_per_token")
PREFIX_KEYS = ("serve_prefix_hit_tokens", "serve_prefix_hits",
               "serve_prefix_cached_pages", "serve_prefix_shared_pages",
               "serve_prefix_cow_copies", "serve_prefix_evicted_pages")


def _prompts(seed, lens):
    rs = np.random.RandomState(seed)
    return [[int(x) for x in rs.randint(2, 256, n)] for n in lens]


def _drain_both(prompts, gens, one_at_a_time=False, submit=None, **over):
    """The traffic on the JAX engine and on the port's; returns both
    engines and both lists of (tokens, log-probs)."""
    jm, jp, tm, tp = tiny_pair()
    kw = dict(BASE, **over)
    submit = submit or dict(top_k=1, return_log_probs=True)
    engines = [JaxEngine(jm, jp, **kw), DecodeEngine(tm, tp, **kw)]
    outs = []
    for eng in engines:
        groups = [[i] for i in range(len(prompts))] if one_at_a_time \
            else [list(range(len(prompts)))]
        res = []
        for grp in groups:
            reqs = [eng.submit(prompts[i], gens[i], **submit) for i in grp]
            eng.drain()
            res += [r.result(timeout=30) for r in reqs]
        outs.append([([int(x) for x in toks], lps) for toks, lps in res])
    return engines, outs


def _assert_same(engines, outs, keys=ACCOUNTING):
    (jeng, peng), (jout, pout) = engines, outs
    for i, ((jt, jl), (pt_, pl)) in enumerate(zip(jout, pout)):
        assert pt_ == jt, f"request {i}"
        if jl is not None:
            close(pl, jl, 1e-5, f"request {i} log-probs")
    jc, pc = jeng.counters(), peng.counters()
    assert {k: pc[k] for k in keys} == {k: jc[k] for k in keys}
    assert sorted(peng._free_pages) == sorted(jeng._free_pages)


@pytest.mark.parametrize("weights,seed", [(False, 0), (True, 1)],
                         ids=["kv", "kv_weights"])
def test_int8_engine_matches_jax(weights, seed):
    """int8 pools (and int8 weights): four mixed-length requests through
    two slots in chunks of 8. A K/V element whose scaled value lies
    within an fp32 ulp of a rounding half step may quantize one level
    apart in the two frameworks (their matmuls differ in the last bit),
    which moves later log-probs by ~1e-4; with int8 weights about half
    of the traffic seeds meet one. The seeds here meet none, so the
    1e-5 bar holds the port to JAX's arithmetic everywhere else."""
    prompts = _prompts(seed, (5, 9, 3, 17))
    engines, outs = _drain_both(prompts, (6, 4, 8, 5),
                                quantize_weights=weights)
    _assert_same(engines, outs)
    c = engines[1].counters()
    assert c["serve_kv_dtype"] == "int8" and c["serve_pages_in_use"] == 0


def test_int8_prefix_cache_cow_matches_jax():
    """int8 pools with the prefix cache: full-page hits and two
    copy-on-write copies (data and scales), at a pool small enough to
    evict; streams and prefix-cache accounting equal JAX's."""
    rs = np.random.RandomState(8)
    shared = [int(x) for x in rs.randint(2, 256, 20)]
    prompts = ([shared + [int(x) for x in rs.randint(2, 256, n)]
                for n in (9, 3, 1)] + _prompts(9, (7, 22, 30)))
    engines, outs = _drain_both(
        prompts, (5, 3, 6, 4, 5, 10), one_at_a_time=True,
        submit=dict(top_k=1), page_size=8, max_context=48, page_budget=64,
        prefill_chunk_tokens=16, step_horizon=2, prefix_cache=True)
    _assert_same(engines, outs, ACCOUNTING + PREFIX_KEYS)
    c = engines[1].counters()
    assert c["serve_prefix_cow_copies"] == 2
    assert c["serve_prefix_evicted_pages"] > 0


def test_int8_pool_gauges_match_jax():
    """Scale pools count in the pool's bytes: int8 holds (d + 4) / (2 d)
    of the fp32-compute bf16 'kv_dtype' bytes per token, here against
    the fp32 pools of the tiny model: (128 + 4) / (4 * 128)."""
    jm, jp, tm, tp = tiny_pair()
    kw = dict(BASE, page_size=32)
    j, p = JaxEngine(jm, jp, **kw), DecodeEngine(tm, tp, **kw)
    fp = DecodeEngine(tm, tp, **dict(kw, kv_dtype="bf16"))
    for key in ("serve_kv_dtype", "serve_kv_pool_bytes",
                "serve_kv_bytes_per_token"):
        assert p.counters()[key] == j.counters()[key], key
    assert p.kv_pool_bytes() * 4 * 128 == fp.kv_pool_bytes() * (128 + 4)


@pytest.mark.parametrize("kv_dtype,seed", [("bf16", 1), ("int8", 4)])
def test_whole_prompt_admission_matches_jax(kv_dtype, seed):
    """prefill_chunk_tokens=0: each prompt's bucket prefix prefilled at
    admission (quantized at write for int8 pools), the rest teacher-
    forced by the decode rounds; prompt log-probs included. The int8
    seed is one whose K/V meet no rounding tie (see
    test_int8_engine_matches_jax): a 64-token prefill writes 64k int8
    values, and two in three seeds put one within an ulp of a half
    step."""
    prompts = _prompts(seed, (5, 9, 3, 17, 70))
    engines, outs = _drain_both(prompts, (6, 4, 8, 5, 3),
                                prefill_chunk_tokens=0, kv_dtype=kv_dtype,
                                max_context=80)
    _assert_same(engines, outs)
