"""PyTorch port, tensor-parallel serving (`serving_tp` > 1) against the
JAX package on the CPU in fp32, the oracles of tests/test_tp_serving.py.

The port's ranks are gloo CPU processes (utils/virtual_mesh.
spawn_cpu_group, rank programs in tests/torch_tp_serving_ranks.py); the
JAX tp 2 engine runs on the conftest's virtual CPU mesh. On shared
weights (the tiny GQA Llama of tests/torch_parity.py, 2 KV groups):

- the sharding rules and construction gates, as JAX's
  `TestPoolSpecRule` and `TestConstructionGates`;
- the port's tp 2 engine (one leader, one follower) against the JAX tp
  2 engine and the JAX single-chip engine on chunked prefill at, below
  and above a page, whole-prompt prefill, the prefix cache's COW with
  eviction, speculative decoding, int8 KV and a sliding window: greedy
  tokens bitwise, log-probs within JAX's LOGPROB_ATOL (5e-6), page and
  prefix accounting exactly equal, every page back after the drain;
- each rank's gauges exactly half the single-card engine's, int8 scale
  pools included; rank r's pools hold groups [r g / tp, (r + 1) g / tp)
  of the single-card engine's; the follower chose the leader's tokens
  in every round;
- the leader's serve loop dying releases the follower, and a follower
  dying fails the leader's loop (GET /health 503);
- the whole-batch route under a tp 2 context (score, greedy, beam)
  against the JAX package's under its tp 2 context, sampled against the
  port's one-rank call of the same seed;
- the pp 2 x tp 2 stage ring against the JAX ring of
  tests/test_pp_inference.py `test_exact_match_pp2_tp2` (and JAX
  `generate_tokens`);
- the port's launcher at `--serving_tp 2` under torchrun: HTTP greedy
  streams equal to the tp 1 launcher's, the banner, no JAX in a rank.
"""

import os
import pickle
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_tp_serving_ranks as R
from megatron_llm_tpu.config import tiny_config as jax_tiny_config
from megatron_llm_tpu.inference import api as jax_api
from megatron_llm_tpu.inference.engine import DecodeEngine as JaxEngine
from megatron_llm_tpu.inference.generation import (
    generate_tokens as jax_generate,
)
from megatron_llm_tpu.models import LlamaModel as JaxLlama
from megatron_llm_tpu.parallel.mesh import destroy_parallel as jax_destroy
from megatron_llm_tpu.parallel.mesh import (
    initialize_parallel as jax_initialize,
)
from megatron_llm_tpu.parallel.pipeline import (
    make_pipelined_decode_fn as jax_ring_fn,
    pipeline_param_specs as jax_pipeline_specs,
)
from megatron_llm_tpu.parallel.sharding import (
    decode_param_specs as jax_decode_specs,
    kv_pool_spec as jax_kv_pool_spec,
    param_specs as jax_param_specs,
)
from megatron_llm_tpu_torch.inference import api
from megatron_llm_tpu_torch.inference.engine import DecodeEngine
from megatron_llm_tpu_torch.parallel.mesh import MODEL_AXIS
from megatron_llm_tpu_torch.parallel.sharding import (
    decode_param_specs,
    kv_pool_axis,
    kv_pool_shard_shape,
    kv_pool_spec,
    shard_decode_params,
)
from megatron_llm_tpu_torch.tools import run_text_generation_server as rtgs
from megatron_llm_tpu_torch.training import checkpointing as ck
from megatron_llm_tpu_torch.utils.virtual_mesh import spawn_cpu_group
from torch_parity import tiny_pair

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX tests/test_tp_serving.py:171
LOGPROB_ATOL = 5e-6
# int8 pools: the tp all-reduce's reordered fp32 sums can move a K/V
# element across a rounding half step, one int8 level (ROADMAP.md C, int8
# ties). The JAX suite holds int8 tokens only for that reason; its own tp
# 2 int8 engine is 1.24e-5 from its single-chip one on this traffic
INT8_LOGPROB_ATOL = 5e-5
TP = 2
PLAIN, WINDOW = (None, 128), (24, 256)  # (attention window, max positions)
BASE = dict(slots=2, page_size=16, max_context=96, max_queue=16,
            prefill_chunk_tokens=16, termination_id=None, vocab_size=256)
_rs = np.random.RandomState(3)
_SYS = [int(x) for x in _rs.randint(2, 256, 40)]
_TAILS = [[int(x) for x in _rs.randint(2, 256, 4)] for _ in range(3)]
# the first request shares 24 tokens (1.5 pages) with the system prompt
# of the later ones: they map its first page and copy its second on write
PREFIX_TRAFFIC = (
    [(_SYS[:24] + [int(x) for x in _rs.randint(2, 256, 12)], 8, True)]
    + [(_SYS + t, 10, False) for t in _TAILS])
# (name, model, engine kwargs over BASE, traffic: (prompt, tokens, lps))
CASES = [
    # chunks at, below and above a page (chunk 16 = page 16)
    ("chunked", PLAIN, {}, [(list(range(5, 45)), 20, True),
                            ([7, 8, 9, 10, 11], 24, True),
                            (list(range(60, 93)), 12, False)]),
    ("whole_prompt", PLAIN, dict(prefill_chunk_tokens=0),
     [(list(range(5, 30)), 12, True), ([3, 4, 5, 6], 10, False)]),
    # 5 pages for 4 requests of 3-4 pages: admission evicts cached ones
    ("prefix_cow_evict", PLAIN, dict(prefix_cache=True, page_budget=80),
     PREFIX_TRAFFIC),
    ("spec", PLAIN, dict(spec_decode_k=3),
     [([11, 12, 13, 14] * 8, 20, True), (list(range(40, 70)), 16, False)]),
    ("int8", PLAIN, dict(kv_dtype="int8", page_size=32,
                         prefill_chunk_tokens=32),
     [(list(range(5, 45)), 16, True), ([7, 8, 9, 10, 11, 12], 12, False)]),
    ("window", WINDOW, dict(max_context=64),
     [(list(range(5, 12)), 12, True), (list(range(3, 6)), 20, False),
      (list(range(2, 26)), 36, True)]),
]
IDS = [c[0] for c in CASES]
PROMPTS = ["5 6 7 8 9 10 11 12 13", "40 41 42 43 44 45 46 47",
           "100 101 102 103 104 105 106 107 108 109 110",
           "3 1 4 1 5 9 2 6"]


def _pair(key):
    window, max_pos = key
    return tiny_pair(window=window, max_pos=max_pos)


def _run(eng, traffic):
    reqs = [eng.submit(list(p), g, top_k=1, return_log_probs=lp)
            for p, g, lp in traffic]
    eng.drain()
    return [r.result(60) for r in reqs]


def _accounting(counters):
    return {k: v for k, v in counters.items()
            if "pages" in k or "prefix" in k}


# ---------------------------------------------------------------------------
# the JAX references and the port's ranks, computed once
# ---------------------------------------------------------------------------

def _ring_setup():
    """JAX tests/test_pp_inference.py TestPipelinedDecode._run's inputs."""
    cfg = dict(num_layers=4, hidden_size=64, num_attention_heads=8,
               num_attention_heads_kv=2, ffn_hidden_size=128, seq_length=64,
               max_position_embeddings=64, padded_vocab_size=256)
    rng = np.random.RandomState(0)
    tokens = np.zeros((4, 32), np.int32)
    lengths = np.array([8, 10, 8, 12], np.int32)
    for i in range(4):
        tokens[i, :lengths[i]] = rng.randint(1, 255, lengths[i])
    return cfg, tokens, lengths, 8


def _jax_ring(cfg_kw):
    """The JAX ring at pp 2 x tp 2 and JAX `generate_tokens` on the same
    weights and inputs."""
    cfg = jax_tiny_config(**cfg_kw, compute_dtype=jnp.float32,
                          params_dtype=jnp.float32)
    model = JaxLlama(cfg)
    _, tokens, lengths, prefill = _ring_setup()
    params = model.init(jax.random.key(0))
    ref = jax_generate(model, params, jnp.asarray(tokens),
                       jnp.asarray(lengths), prefill_len=prefill,
                       return_log_probs=True)
    ctx = jax_initialize(dp=1, pp=2, tp=2, devices=jax.devices()[:4])
    try:
        specs = jax_pipeline_specs(cfg, params)
        sh = jax.tree.map(lambda s: NamedSharding(ctx.mesh, s), specs,
                          is_leaf=lambda x: isinstance(x, P))
        from megatron_llm_tpu.config import ParallelConfig

        dec = jax.jit(jax_ring_fn(
            model, ParallelConfig(pipeline_parallel_size=2,
                                  tensor_parallel_size=2), ctx,
            prefill_len=prefill, max_len=tokens.shape[1], greedy=True,
            return_log_probs=True))
        out = dec(jax.device_put(params, sh), jnp.asarray(tokens),
                  jnp.asarray(lengths))
        ring = tuple(np.asarray(x) for x in out)
    finally:
        jax_destroy()
    return jax.tree.map(np.asarray, params), ring, (
        np.asarray(ref.tokens), np.asarray(ref.log_probs))


def _jax_api_tp2(jm, jp):
    """The JAX API under a tp 2 context on its virtual mesh, the params
    sharded by `param_specs`: score, greedy with log-probs, beam."""
    tok = R.ByteTokenizer()
    ctx = jax_initialize(dp=1, tp=2, devices=jax.devices()[:2])
    try:
        specs = jax_param_specs(jm.cfg, jp)
        sh = jax.tree.map(lambda s: NamedSharding(ctx.mesh, s), specs,
                          is_leaf=lambda x: isinstance(x, P))
        params = jax.device_put(jp, sh)
        out = {}
        for name, call in (
                ("score", lambda: jax_api.generate_and_post_process(
                    jm, params, tok, PROMPTS, 0)),
                ("greedy", lambda: jax_api.generate_and_post_process(
                    jm, params, tok, PROMPTS, 12,
                    return_output_log_probs=True, top_k_sampling=1)),
                ("beam", lambda: jax_api.beam_search_and_post_process(
                    jm, params, tok, PROMPTS[:1], 6, beam_size=2))):
            texts, _, lp, toks = call()
            out[name] = (texts, None if lp is None else np.asarray(lp),
                         np.asarray(toks))
        return out
    finally:
        jax_destroy()


@pytest.fixture(scope="module")
def results():
    params_np, jax_ref = {}, {}
    for key in (PLAIN, WINDOW):
        _, jp, _, _ = _pair(key)
        params_np[key] = jax.tree.map(np.asarray, jp)
    port1 = {}
    for name, key, kw, traffic in CASES:
        jm, jp, tm, tp = _pair(key)
        kw = dict(BASE, **kw)
        refs = {}
        for tp_ in (1, TP):
            eng = JaxEngine(jm, jp, serving_tp=tp_, **kw)
            refs[tp_] = {"streams": _run(eng, traffic),
                         "counters": eng.counters(),
                         "spec": (eng._spec_rounds, eng._spec_proposed,
                                  eng._spec_accepted)}
        jax_ref[name] = refs
        eng = DecodeEngine(tm, tp, **kw)
        port1[name] = {"streams": _run(eng, traffic),
                       "pools": R._np_pools(eng),
                       "kv_pool_bytes": eng.kv_pool_bytes(),
                       "kv_bytes_per_token": eng.kv_bytes_per_token(),
                       "counters": eng.counters()}
    ring_cfg = _ring_setup()[0]
    ring_params, jax_ring, jax_ring_ref = _jax_ring(ring_cfg)
    _, tokens, lengths, prefill = _ring_setup()
    jm, jp, tm, tp = _pair(PLAIN)
    jax_api_out = _jax_api_tp2(jm, jp)
    tok = R.ByteTokenizer()
    one = {"sampled": api.generate_and_post_process(
        tm, tp, tok, PROMPTS, 12, top_k_sampling=4, random_seed=7)}
    cases = [(name, key, dict(BASE, **kw), traffic)
             for name, key, kw, traffic in CASES]
    port2 = spawn_cpu_group(TP, R.suite, [
        ("engine_runs", (cases, params_np)),
        ("leader_death", (params_np[PLAIN],)),
        ("follower_death", (params_np[PLAIN],)),
        ("api_requests", (params_np[PLAIN], PROMPTS))], timeout_s=300)
    ring_kw = dict(ring_cfg, compute_dtype=torch.float32)
    port4 = spawn_cpu_group(4, R.suite, [
        ("ring_decode", (ring_kw, ring_params, tokens, lengths, prefill))],
        timeout_s=240)
    return {"jax": jax_ref, "port1": port1, "port2": port2,
            "port4": port4, "jax_ring": jax_ring,
            "jax_ring_ref": jax_ring_ref, "jax_api": jax_api_out,
            "one": one}


def _ranks(results, name):
    i = IDS.index(name)
    return [r[0][i] for r in results["port2"]]


# ---------------------------------------------------------------------------
# the sharding rules and the construction gates
# ---------------------------------------------------------------------------

def test_kv_pool_axis_is_the_group_axis_or_none():
    assert kv_pool_axis((9, 16, 4, 8), 2) == 2   # data pool
    assert kv_pool_axis((9, 16, 4), 2) == 2      # int8 scale pool
    assert kv_pool_axis((9, 16, 4, 8), 1) is None  # tp=1
    assert kv_pool_axis((9, 16, 3, 8), 2) is None  # indivisible
    assert kv_pool_axis((9, 16, 1, 8), 2) is None  # MQA: g < tp


@pytest.mark.parametrize("shape,tp", [((9, 16, 4, 8), 2), ((9, 16, 4), 2),
                                      ((9, 16, 4, 8), 1), ((9, 16, 3, 8), 2),
                                      ((9, 16, 8, 8), 4)])
def test_kv_pool_spec_is_the_jax_spec(shape, tp):
    assert kv_pool_spec(shape, tp) == tuple(jax_kv_pool_spec(shape, tp))
    if kv_pool_axis(shape, tp) is not None:
        assert kv_pool_spec(shape, tp)[2] == MODEL_AXIS
        assert kv_pool_shard_shape(shape, tp)[2] == shape[2] // tp


def test_decode_param_specs_refuses_flattened_glu():
    _, _, tm, tp = tiny_pair()
    with pytest.raises(AssertionError, match="UNFLATTENED"):
        decode_param_specs(tm.cfg, tm.prepare_decode_params(tp))


def test_decode_param_specs_are_the_jax_specs():
    """Leaf for leaf the JAX package's `decode_param_specs` on its
    unflattened decode tree."""
    jm, jp, tm, tp = tiny_pair()
    want = jax_decode_specs(jm.cfg, jm.prepare_decode_params(
        jp, flatten_glu=False))
    got = decode_param_specs(tm.cfg, tm.prepare_decode_params(
        tp, flatten_glu=False))

    def norm(x):
        if isinstance(x, P):
            return tuple(x)
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(norm(v) for v in x)
        return x

    def strip(spec):  # trailing Nones are the same spec
        parts = list(spec)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def same(a, b, path=""):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, tuple) and a and isinstance(a[0], (dict, tuple)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}/{i}")
        else:
            assert strip(a) == strip(b), path

    same(norm(got), norm(want))
    assert got["layers"][0]["mlp"]["w1"] == (None, None, MODEL_AXIS)


def test_shard_decode_params_cuts_each_rank_its_slice():
    """Each split leaf is rank r's contiguous block on its spec's axis;
    the ranks' blocks rebuild the whole leaf."""
    _, _, tm, tp = tiny_pair()
    dec = tm.prepare_decode_params(tp, flatten_glu=False)
    shards = [shard_decode_params(dec, tm.cfg, TP, r) for r in range(TP)]
    for name, axis in (("wqkv", 1), ("wo", 0)):
        whole = dec["layers"][1]["attention"][name]
        parts = [s["layers"][1]["attention"][name] for s in shards]
        assert torch.equal(torch.cat(parts, axis), whole)
    w1 = dec["layers"][0]["mlp"]["w1"]
    assert torch.equal(torch.cat([s["layers"][0]["mlp"]["w1"]
                                  for s in shards], 2), w1)
    assert torch.equal(torch.cat([s["embedding"]["word_embeddings"]
                                  for s in shards], 0),
                       dec["embedding"]["word_embeddings"])
    assert shards[1]["final_norm"]["scale"] is dec["final_norm"]["scale"]


def test_serving_tp_must_divide_groups():
    _, _, tm, tp = tiny_pair()
    assert tm.cfg.num_query_groups == 2
    with pytest.raises(ValueError, match="divide the KV group"):
        DecodeEngine(tm, tp, serving_tp=4, **BASE)


def test_quantize_weights_refused_on_a_tp_engine():
    _, _, tm, tp = tiny_pair()
    with pytest.raises(ValueError, match="single-chip-layout"):
        DecodeEngine(tm, tp, serving_tp=2, quantize_weights=True, **BASE)


def test_flattened_glu_refused_for_the_int8_tree():
    _, _, tm, tp = tiny_pair()
    with pytest.raises(ValueError, match="flattened GLU"):
        tm.prepare_decode_params(tp, quantize_int8=True, flatten_glu=False)


def test_devices_name_one_device_a_rank():
    _, _, tm, tp = tiny_pair()
    with pytest.raises(ValueError, match="one per tp rank"):
        DecodeEngine(tm, tp, devices=["cpu", "cpu"], **BASE)


def test_a_tp1_engine_pinned_by_devices_serves_as_the_plain_one():
    """`devices=[d]` pins a tp = 1 engine on d; its streams are the
    plain engine's, and `replica_id` tags its counters first."""
    _, _, tm, tp = tiny_pair()
    traffic = CASES[0][3][:2]
    plain = _run(DecodeEngine(tm, tp, **BASE), traffic)
    eng = DecodeEngine(tm, tp, devices=[torch.device("cpu")], replica_id=3,
                       **BASE)
    assert _run(eng, traffic) == plain
    c = eng.counters()
    assert next(iter(c)) == "serve_replica_id" and c["serve_replica_id"] == 3
    assert "serve_captured" not in c and "[replica 3]" in eng.describe()
    assert eng._name("decode-engine") == "decode-engine-r3"


def test_the_launcher_needs_a_rank_a_tp_rank():
    """`--serving_tp 2` outside a group of two ranks raises, saying how
    to launch it."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        rtgs.main(["--load", "no_such_dir", "--serving_tp", "2"],
                  device="cpu")


# ---------------------------------------------------------------------------
# the tp 2 engine against the JAX engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", IDS)
def test_tp2_streams_match_the_jax_tp2_and_single_chip_engines(results,
                                                               name):
    got = _ranks(results, name)[0]["streams"]
    atol = INT8_LOGPROB_ATOL if name == "int8" else LOGPROB_ATOL
    for tp_ in (TP, 1):
        want = results["jax"][name][tp_]["streams"]
        assert len(got) == len(want)
        for i, ((gt, gl), (wt, wl)) in enumerate(zip(got, want)):
            assert list(map(int, gt)) == list(map(int, wt)), \
                f"request {i} against the JAX tp {tp_} engine"
            if wl is None:
                assert gl is None
            else:
                np.testing.assert_allclose(gl, wl, rtol=0, atol=atol,
                                           err_msg=f"request {i}, tp {tp_}")


@pytest.mark.parametrize("name", IDS)
def test_page_accounting_equals_the_jax_engines(results, name):
    """Pages in use, the free list and the prefix cache's gauges are the
    leader's host bookkeeping: exactly the JAX tp 2 and single-chip
    engines'; without a prefix cache every page is back after the
    drain."""
    r0 = _ranks(results, name)[0]
    acc = _accounting(r0["counters"])
    for tp_ in (TP, 1):
        assert acc == _accounting(results["jax"][name][tp_]["counters"])
    assert acc == _accounting(results["port1"][name]["counters"])
    if "prefix_cache" not in dict(CASES[IDS.index(name)][2]):
        assert r0["free_pages"] == list(range(1, r0["num_pages"]))
        assert r0["counters"]["serve_pages_in_use"] == 0


def test_prefix_cow_evicts_and_shares(results):
    c = _ranks(results, "prefix_cow_evict")[0]["counters"]
    assert c["serve_prefix_hits"] >= 1
    assert c["serve_prefix_cow_copies"] >= 1
    assert c["serve_prefix_evicted_pages"] >= 1


def test_spec_acceptance_equals_the_jax_engines(results):
    got = _ranks(results, "spec")[0]["spec"]
    assert got[0] > 0 and got[2] > 0
    for tp_ in (TP, 1):
        assert got == results["jax"]["spec"][tp_]["spec"]


@pytest.mark.parametrize("name", IDS)
def test_each_rank_chose_the_leaders_tokens_every_round(results, name):
    r0, r1 = _ranks(results, name)
    assert len(r0["rounds"]) == len(r1["rounds"]) > 0
    for t, (a, b) in enumerate(zip(r0["rounds"], r1["rounds"])):
        np.testing.assert_array_equal(a, b, err_msg=f"round {t}")


@pytest.mark.parametrize("name", IDS)
def test_rank_pools_hold_their_groups(results, name):
    """Rank r's page pools (and int8 scale pools) hold groups [r g / tp,
    (r + 1) g / tp) of the single-card engine's pools after the same
    traffic, and nothing of the other groups."""
    one = results["port1"][name]["pools"]
    g = one[0][0].shape[2]
    for r, rank in enumerate(_ranks(results, name)):
        assert rank["tp_rank"] == r
        own = slice(r * g // TP, (r + 1) * g // TP)
        other = slice((1 - r) * g // TP, (2 - r) * g // TP)
        for kind, (mine, whole) in enumerate(zip(rank["pools"], one)):
            assert len(mine) == len(whole)
            for layer, (a, b) in enumerate(zip(mine, whole)):
                a, b = a.astype(np.float64), b.astype(np.float64)
                assert a.shape[2] == g // TP
                # an int8 element may land one level apart (the row-
                # parallel sums reorder in fp32)
                tol = 1.0 if rank["pools"][0][0].dtype == np.int8 \
                    and kind < 2 else 1e-4
                np.testing.assert_allclose(
                    a, b[:, :, own], rtol=0, atol=tol,
                    err_msg=f"rank {r} pool {kind} layer {layer}")
                assert np.abs(a - b[:, :, other]).max() > 10 * tol


@pytest.mark.parametrize("name", ["chunked", "int8"])
def test_each_rank_reports_half_the_pool_bytes(results, name):
    """Per-rank gauges: exactly 1 / tp of the single-card engine's, the
    int8 scale pools included; counters() and the start line agree."""
    one = results["port1"][name]
    for rank in _ranks(results, name):
        assert one["kv_pool_bytes"] == TP * rank["kv_pool_bytes"]
        assert one["kv_bytes_per_token"] == TP * rank["kv_bytes_per_token"]
    r0 = _ranks(results, name)[0]
    c = r0["counters"]
    assert c["serve_kv_pool_bytes"] == r0["kv_pool_bytes"]
    assert c["serve_captured"] is False
    assert f"tp={TP} (group-sharded, gloo, rounds uncaptured)" \
        in r0["describe"]
    if name == "int8":
        assert c["serve_kv_dtype"] == "int8"


# ---------------------------------------------------------------------------
# shutdown
# ---------------------------------------------------------------------------

def test_the_leaders_death_releases_the_follower(results):
    leader, follower = results["port2"][0][1], results["port2"][1][1]
    assert "injected admission fault" in leader["error"]
    assert leader["health"]["broken"] is not None
    assert not leader["health"]["alive"] and leader["released"]
    assert follower["follower_returned"]
    assert follower["rounds"] == leader["rounds"] > 0
    assert follower["s"] < 60


def test_a_followers_death_fails_the_leaders_loop(results):
    leader, follower = results["port2"][0][2], results["port2"][1][2]
    assert "injected follower fault" in follower["error"]
    assert leader["error"] is not None
    assert leader["health"]["broken"] is not None
    assert not leader["health"]["alive"]


# ---------------------------------------------------------------------------
# the whole-batch route under a tp 2 context, and the pp x tp ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["score", "greedy", "beam"])
def test_the_whole_batch_route_at_tp2_matches_jax_at_tp2(results, name):
    ranks = [r[3][name] for r in results["port2"]]
    for r in ranks[1:]:
        assert r[0] == ranks[0][0]
        np.testing.assert_array_equal(r[2], ranks[0][2])
    texts, lp, toks = ranks[0]
    want = results["jax_api"][name]
    assert texts == want[0]
    np.testing.assert_array_equal(toks, want[2])
    if name == "beam":
        np.testing.assert_allclose(lp, want[1], rtol=1e-5)
    else:
        np.testing.assert_allclose(lp, want[1], rtol=0, atol=1e-5)


def test_a_sampled_request_at_tp2_draws_the_one_rank_stream(results):
    """Sampling draws are the port's own (ROADMAP.md C, sampling draws):
    at tp 2 the seeded stream equals the one-rank call's."""
    ranks = [r[3]["sampled"] for r in results["port2"]]
    one = results["one"]["sampled"]
    for texts, _, toks in ranks:
        assert texts == one[0]
        np.testing.assert_array_equal(toks, one[3])


def test_the_pp2_tp2_ring_matches_jax(results):
    """JAX `test_exact_match_pp2_tp2`'s setup: every rank's tokens equal
    the JAX ring's and JAX `generate_tokens`', lengths the JAX ring's,
    log-probs within 1e-5 of both."""
    got = results["port4"]
    toks, lens, lps = got[0][0]
    for r in got[1:]:
        for a, b in zip(r[0], got[0][0]):
            np.testing.assert_array_equal(a, b)
    ring, (ref_toks, ref_lps) = results["jax_ring"], results["jax_ring_ref"]
    np.testing.assert_array_equal(toks, ring[0])
    np.testing.assert_array_equal(toks, ref_toks)
    np.testing.assert_array_equal(lens, ring[1])
    np.testing.assert_allclose(lps, ring[2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(lps, ref_lps, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the launcher under torchrun
# ---------------------------------------------------------------------------

def _payloads():
    rs = np.random.RandomState(21)
    return [{"prompts": [" ".join(map(str, rs.randint(2, 255, n)))],
             "tokens_to_generate": 8, "logprobs": True, "top_k": 1}
            for n in (5, 13, 9)]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The tp 1 launcher in-process and the tp 2 launcher under torchrun
    on one release, the same requests."""
    tmp = tmp_path_factory.mktemp("tp_launcher")
    _, _, tm, tp = tiny_pair()
    save_dir = str(tmp / "release_ckpt")
    ck.save_checkpoint(save_dir, 0, tp, model_cfg=tm.cfg, release=True)
    argv = ["--load", save_dir, "--host", "127.0.0.1", "--port", "0",
            "--tokenizer_type", "NullTokenizer", "--null_vocab_size", "255",
            "--serving_slots", "2", "--page_size", "16", "--max_context",
            "64", "--prefill_chunk_tokens", "8"]
    one = {}
    thread = threading.Thread(target=lambda: one.update(
        R.launch(argv, _payloads())))
    thread.start()
    thread.join(timeout=300)
    assert not thread.is_alive()
    d = str(tmp)
    with open(os.path.join(d, "spec.pkl"), "wb") as f:
        pickle.dump({"argv": argv + ["--serving_tp", "2",
                                     "--distributed_backend", "gloo"],
                     "payloads": _payloads()}, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([REPO, os.path.join(REPO, "tests")])
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2",
         os.path.join(REPO, "tests", "torch_tp_serving_ranks.py"), d],
        cwd=d, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    ranks = []
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return one, ranks


def test_the_tp2_launcher_streams_equal_the_tp1_launchers(launched):
    one, (r0, _) = launched
    assert len(r0["answers"]) == len(one["answers"]) == 3
    for (s2, a2), (s1, a1) in zip(r0["answers"], one["answers"]):
        assert s1 == s2 == 200, (a1, a2)
        assert a2["text"] == a1["text"]
        np.testing.assert_allclose(a2["logprobs"], a1["logprobs"], rtol=0,
                                   atol=LOGPROB_ATOL)
    assert r0["counters"]["serve_admitted"] == 3
    assert r0["counters"]["serve_captured"] is False


def test_the_tp2_launchers_banner_and_ranks(launched):
    one, (r0, r1) = launched
    banner = [x for x in r0["lines"] if x.startswith("serving llama")]
    assert len(banner) == 1
    assert "tp2 mesh (gloo, rounds uncaptured), continuous batching: 2 " \
        "slots" in banner[0]
    assert "MiB/chip pool" in banner[0] and "B/token/chip" in banner[0]
    assert "tp2 mesh" not in one["lines"][-1]
    # the follower serves no HTTP and prints no banner
    assert "answers" not in r1 and not any(
        x.startswith("serving") for x in r1["lines"])
    assert r0["jax_modules"] == r1["jax_modules"] == []
