"""PyTorch port, the KV page hand-off (`export_prefix` / `import_prefix`
of inference/engine.py) and disaggregated two-stage serving, against the
JAX engine on the tiny fp32 Llama of both packages (shared weights).

- the donor's payload: the same prefix tokens, page count, page size and
  dtype; page rows within 1e-5 (fp32 pools), int8 data equal and scales
  within 1e-6;
- a receiver that imports its package's payload (and the port's receiver
  fed the JAX payload) decodes the JAX engine's greedy stream, with the
  pages it imported as prefix hits;
- refcounts, free pages and prefix-cache stats exactly equal after the
  import and after the request; the geometry, dtype and prefix-cache
  gates raise as JAX's do; a full receiver pool answers False; the
  modeled backlog FLOPs equal JAX's;
- two-stage routing over two real tiny engines a side (a prefill and a
  decode replica) gives JAX's streams and hand-off stats.
"""

import numpy as np
import pytest
import torch

from megatron_llm_tpu.inference import engine as jax_engine
from megatron_llm_tpu.inference import router as jax_router
from megatron_llm_tpu_torch.inference import engine as pt_engine
from megatron_llm_tpu_torch.inference import router as pt_router
from torch_parity import close, tiny_pair

KW = dict(slots=2, page_size=16, max_context=96, max_queue=16,
          prefill_chunk_tokens=16, prefix_cache=True, vocab_size=256,
          termination_id=None)


def _engines(**over):
    """(JAX engine, port engine) on shared weights."""
    jm, jp, tm, tp = tiny_pair(max_pos=96)
    kw = dict(KW, **over)
    return (jax_engine.DecodeEngine(jm, jp, **kw),
            pt_engine.DecodeEngine(tm, tp, **kw))


def _prompt(n, seed=0):
    return [int(x) for x in np.random.RandomState(seed).randint(2, 256, n)]


def _prefill(eng, prompt):
    req = eng.submit(prompt, 1, top_k=1)
    eng.drain()
    req.result(60)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        and x.dtype != torch.int8 else np.asarray(x)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_payload_equals_jax(kv_dtype):
    """The prompt's seed keeps every K/V element away from an int8
    rounding half step: within an fp32 ulp of one, the two packages'
    prefills quantize one level apart (ROADMAP.md C, accepted
    divergences), which is the prefill's, not the hand-off's; the
    hand-off's own exactness is held below, payload to pool."""
    prompt = _prompt(40, seed=1)
    donors = _engines(kv_dtype=kv_dtype)
    for eng in donors:
        _prefill(eng, prompt)
    ref, got = (eng.export_prefix(prompt) for eng in donors)
    for key in ("tokens", "pages", "page_size", "dtype"):
        assert got[key] == ref[key], key
    assert got["pages"] == 2 and len(got["tokens"]) == 32
    for name in ("k", "v"):
        assert len(got[name]) == len(ref[name]) > 0
        for a, b in zip(got[name], ref[name]):
            assert tuple(a.shape) == b.shape
            if kv_dtype == "int8":
                np.testing.assert_array_equal(_np(a), np.asarray(b))
            else:
                close(_np(a), np.asarray(b), 1e-5, name)
    for name in ("ks", "vs"):
        assert len(got[name]) == len(ref[name])
        for a, b in zip(got[name], ref[name]):
            close(_np(a), np.asarray(b), 1e-6, name)
    assert donors[1].counters()["serve_transfer_pages_out"] == 2


@pytest.mark.parametrize("source", ["own", "jax_payload"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_import_decodes_the_jax_stream(kv_dtype, source):
    """Each package's receiver imports a donor payload and decodes the
    prompt; the streams equal, the imported pages are prefix hits, and
    the pool accounting (free pages, prefix stats) equals JAX's."""
    prompt = _prompt(40, seed=3)
    donors = _engines(kv_dtype=kv_dtype)
    for eng in donors:
        _prefill(eng, prompt)
    payloads = [eng.export_prefix(prompt) for eng in donors]
    if source == "jax_payload":
        payloads[1] = payloads[0]
    receivers = _engines(kv_dtype=kv_dtype)
    res = [r.import_prefix(p) for r, p in zip(receivers, payloads)]
    assert res[0] == res[1] == {"pages": 2, "registered": 2}
    # the port's import wrote the payload's rows into its pools exactly
    pages = torch.as_tensor(receivers[1]._prefix.lookup(prompt).pages[:2])
    for name, pools in zip(("k", "v", "ks", "vs"), receivers[1]._pools):
        for pool, rows in zip(pools, payloads[1][name]):
            assert torch.equal(pool.index_select(0, pages),
                               torch.as_tensor(np.asarray(rows)))
    assert receivers[1]._free_pages == receivers[0]._free_pages
    assert receivers[1]._prefix.stats() == receivers[0]._prefix.stats()
    reqs = [r.submit(prompt, 8, top_k=1) for r in receivers]
    for r in receivers:
        r.drain()
    ref, got = (q.result(60)[0] for q in reqs)
    assert got == ref
    c = [r.counters() for r in receivers]
    for key in ("serve_prefix_hits", "serve_transfer_pages_in",
                "serve_pages_free", "serve_prefill_tokens"):
        assert c[1][key] == c[0][key], key
    assert c[1]["serve_prefix_hits"] >= 1
    assert receivers[1]._free_pages == receivers[0]._free_pages
    # transferred pages are registered but unreferenced: evictable alike
    assert receivers[1]._prefix.evict(2) == receivers[0]._prefix.evict(2)


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001: both packages must agree
        return type(e).__name__, str(e)
    return None


def test_gates_raise_as_jax():
    prompt = _prompt(40)
    donors = _engines()
    for eng in donors:
        _prefill(eng, prompt)
    payload = donors[1].export_prefix(prompt)
    int8 = _engines(kv_dtype="int8")
    for eng in int8:
        _prefill(eng, prompt)
    int8_payload = int8[1].export_prefix(prompt)
    cases = [
        ({"page_size": 32, "max_context": 192}, payload),
        ({}, dict(payload, tokens=payload["tokens"][:-1])),
        ({}, dict(payload, dtype="int8")),
        ({}, dict(payload, pages=0)),
        ({}, dict(payload, pages=99)),
        ({}, [1, 2]),
        ({"kv_dtype": "int8"}, dict(int8_payload, ks=[])),
        ({}, int8_payload),
        ({"prefix_cache": False, "prefill_chunk_tokens": 0}, payload),
    ]
    for over, bad in cases:
        jax_eng, pt_eng = _engines(**over)
        ref = _raised(lambda: jax_eng.import_prefix(bad))
        assert ref is not None and _raised(
            lambda: pt_eng.import_prefix(bad)) == ref, (over, ref)
    jax_eng, pt_eng = _engines(prefix_cache=False, prefill_chunk_tokens=0)
    assert _raised(lambda: pt_eng.export_prefix(prompt)) \
        == _raised(lambda: jax_eng.export_prefix(prompt))
    # misses: never prefilled, or no full page of it
    for eng in _engines():
        assert eng.export_prefix(_prompt(40, seed=9)) is None
        short = _prompt(8)
        _prefill(eng, short)
        assert eng.export_prefix(short) is None


def test_full_receiver_pool_returns_false():
    prompt = _prompt(40)
    donor = _engines()[1]
    _prefill(donor, prompt)
    payload = donor.export_prefix(prompt)
    for eng in _engines():
        held = list(eng._free_pages)
        eng._free_pages.clear()
        assert eng.import_prefix(payload) is False
        eng._free_pages.extend(held)


def test_modeled_backlog_equals_jax():
    """The cost registry's modeled FLOPs (2 N a computed token over the
    decode tree and the attention integral) equal the JAX engine's for
    the same queued work; the Retry-After clamps to [1, 60] s."""
    engines = _engines(cost_registry=True)
    for eng in engines:
        assert eng.modeled_backlog_flops() == 0.0
        assert eng.retry_after_s() == 1.0
        eng.submit(_prompt(64), 16, top_k=1)
        eng.submit(_prompt(20, seed=1), 8, top_k=1)
    ref, got = (eng.modeled_backlog_flops() for eng in engines)
    assert got == ref > 0
    port = engines[1]
    assert port.modeled_backlog_seconds() is None  # no card: no chip
    port.chip = port.costs.chip = __import__(
        "megatron_llm_tpu_torch.telemetry.chipspec",
        fromlist=["x"]).detect_chip(override="h100")
    assert port.modeled_backlog_seconds() == pytest.approx(got / 989e12)
    port.modeled_backlog_seconds = lambda: 500.0
    assert port.retry_after_s() == 60.0
    _, off = _engines()
    off.submit(_prompt(64), 16, top_k=1)
    assert off.modeled_backlog_flops() is None and off.retry_after_s() == 1.0


def _two_stage(pkg_engine, pkg_router, model, params, prompts):
    pre = pkg_engine.DecodeEngine(model, params, replica_id=0, **KW)
    dec = pkg_engine.DecodeEngine(model, params, replica_id=1,
                                  spec_decode_k=2, **KW)
    router = pkg_router.ReplicaRouter(
        prefill_replicas=[pkg_router.EngineReplica(pre)],
        decode_replicas=[pkg_router.EngineReplica(dec)],
        disagg_min_prompt_pages=2)
    router.start()
    try:
        reqs = [router.submit(p, 8, top_k=1) for p in prompts]
        streams = [r.result(120)[0] for r in reqs]
    finally:
        router.stop(drain=True)
    stats = {k: v for k, v in router.router_stats().items()
             if not k.endswith("_ms")}
    paths = sorted(d["path"] for d in router.decision_log())
    return streams, stats, paths, dec.counters()["serve_prefix_hits"]


def test_two_stage_routing_over_real_engines_equals_jax():
    """A prefill replica and a spec-decoding decode replica a side: the
    two long prompts hand their pages off (40 tokens -> 2 pages, 56 ->
    3), the short one goes direct; streams, stats and paths equal the
    JAX router's over JAX engines, and the single-engine oracle's."""
    jm, jp, tm, tp = tiny_pair(max_pos=96)
    prompts = [_prompt(40, seed=1), _prompt(56, seed=2), _prompt(8, seed=4)]
    got = _two_stage(pt_engine, pt_router, tm, tp, prompts)
    ref = _two_stage(jax_engine, jax_router, jm, jp, prompts)
    assert got == ref
    streams, stats, paths, hits = got
    assert stats["serve_prefill_replica"] == 2
    assert stats["serve_transfer_pages"] == 5
    assert paths == ["direct", "two_stage", "two_stage"] and hits >= 2
    oracle = pt_engine.DecodeEngine(tm, tp, **KW)
    oreqs = [oracle.submit(p, 8, top_k=1) for p in prompts]
    oracle.drain()
    assert streams == [r.result(60)[0] for r in oreqs]


def test_handoff_refused_at_tp_above_one():
    """At serving_tp > 1 (a leader with group-sharded pools) export and
    import raise by name: the hand-off of sharded pools is queued."""
    eng = _engines()[1]
    eng.serving_tp = 2
    for call in (lambda: eng.export_prefix([1, 2, 3]),
                 lambda: eng.import_prefix({"pages": 1})):
        with pytest.raises(ValueError, match="serving_tp=2.*ROADMAP"):
            call()
