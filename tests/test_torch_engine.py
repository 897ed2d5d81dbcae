"""PyTorch port, the continuous-batching engine (inference/engine.py) on
the CPU in fp32 against the JAX package on shared weights: greedy streams
equal to JAX `generate_tokens` run alone on each prompt (the oracle of
tests/test_engine.py), horizon invariance, eod termination, the prefix
cache with a copy-on-write page, the same traffic through the JAX
`DecodeEngine` with exactly equal accounting, the refusals, seeded
sampling, the per-row top-p threshold and the knobs of later slices."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.inference.engine import DecodeEngine as JaxEngine
from megatron_llm_tpu.inference.generation import (
    bucket_prefill_len,
    generate_tokens as jax_generate,
)
from megatron_llm_tpu.inference.sampling import (
    modify_logits_for_top_p as jax_top_p,
)
from megatron_llm_tpu_torch.inference.engine import (
    DecodeEngine,
    QueueFull,
    horizon_buckets,
    mixed_width_buckets,
)
from megatron_llm_tpu_torch.inference.sampling import modify_logits_for_top_p
from torch_parity import close, t, tiny_pair

PROMPT_LENS = (5, 9, 3, 17)
GENS = (6, 4, 8, 5)


def _engine(**over):
    _, _, tm, tp = tiny_pair()
    kw = dict(slots=2, page_size=16, max_context=64, max_queue=8,
              termination_id=None, vocab_size=256, prefill_chunk_tokens=8)
    kw.update(over)
    return DecodeEngine(tm, tp, **kw)


def _prompts(seed, lens=PROMPT_LENS):
    rs = np.random.RandomState(seed)
    return [[int(x) for x in rs.randint(2, 256, n)] for n in lens]


@functools.lru_cache(maxsize=None)
def _reference(prompt, gen, eod=None):
    """JAX `generate_tokens` alone on one prompt at its prefill bucket:
    (tokens, log_probs, length)."""
    jm, jp, _, _ = tiny_pair()
    buf = np.zeros((1, len(prompt) + gen), np.int32)
    buf[0, :len(prompt)] = prompt
    out = jax_generate(
        jm, jp, jnp.asarray(buf), jnp.asarray([len(prompt)], np.int32),
        prefill_len=bucket_prefill_len(len(prompt)), rng=None, top_k=1,
        return_log_probs=True, vocab_size=256, termination_id=eod,
        use_eod_for_early_termination=eod is not None)
    return ([int(x) for x in np.asarray(out.tokens)[0]],
            np.asarray(out.log_probs)[0], int(np.asarray(out.lengths)[0]))


def _run(eng, prompts, gens, **kw):
    reqs = [eng.submit(p, g, **kw) for p, g in zip(prompts, gens)]
    eng.drain()
    return [r.result(timeout=5) for r in reqs]


def test_greedy_streams_equal_jax_generate_tokens():
    """Four mixed-length requests through two slots (admission happens
    mid-flight) in chunks of 8 (prompts span chunks): every request's
    tokens equal JAX `generate_tokens` on that prompt alone; log-probs
    within 1e-5."""
    prompts = _prompts(0)
    eng = _engine()
    outs = _run(eng, prompts, GENS, top_k=1, return_log_probs=True)
    for i, (p, g, (toks, lps)) in enumerate(zip(prompts, GENS, outs)):
        ref_toks, ref_lp, _ = _reference(tuple(p), g)
        assert len(toks) == len(p) + g
        assert toks == ref_toks[:len(toks)], i
        close(lps, ref_lp[:len(toks) - 1], 1e-5, f"request {i}")
    c = eng.counters()
    assert c["serve_admitted"] == c["serve_retired"] == 4
    assert c["serve_pages_in_use"] == 0
    assert sorted(eng._free_pages) == list(range(1, eng.num_pages))


def test_horizon_invariance():
    prompts = _prompts(12, (5, 9, 3))
    gens = (6, 4, 7)
    a = _run(_engine(step_horizon=1), prompts, gens, top_k=1,
             return_log_probs=True)
    b = _run(_engine(step_horizon=8), prompts, gens, top_k=1,
             return_log_probs=True)
    assert a == b


def test_eod_termination_matches():
    prompt = tuple(_prompts(3, (4,))[0])
    free_toks, _, _ = _reference(prompt, 16)
    eod = free_toks[8]  # a token greedy decode will emit
    ref_toks, _, ref_len = _reference(prompt, 16, eod)
    (toks, _), = _run(_engine(max_context=32, termination_id=eod),
                      [list(prompt)], [16], top_k=1)
    assert toks == ref_toks[:ref_len]
    assert toks[-1] == eod


def test_prefix_cache_hit_and_cow_keep_the_streams():
    """Two requests share 24 tokens (1.5 pages of 16): the second maps
    the first's first page and copies its second, half-matching page on
    write. Streams equal those of the engine without the prefix cache."""
    rs = np.random.RandomState(4)
    shared = [int(x) for x in rs.randint(2, 256, 24)]
    # the first prompt fills two pages, so both are registered
    prompts = [shared + [int(x) for x in rs.randint(2, 256, 10)],
               shared + [int(x) for x in rs.randint(2, 256, 3)]]
    outs = []
    for on in (True, False):
        eng = _engine(prefix_cache=on, max_context=48)
        # one at a time, so the first has registered its page before
        # the second is looked up
        outs.append([_run(eng, [p], [6], top_k=1)[0] for p in prompts])
    assert outs[0] == outs[1]
    on = _engine(prefix_cache=True, max_context=48)
    for p in prompts:
        _run(on, [p], [6], top_k=1)
    c = on.counters()
    assert c["serve_prefix_hits"] == 1 and c["serve_prefix_cow_copies"] == 1
    assert c["serve_prefix_hit_tokens"] == 24
    assert c["serve_pages_free"] + c["serve_prefix_cached_pages"] \
        == on.num_pages - 1


def _accounting(eng):
    c = eng.counters()
    keys = ("serve_admitted", "serve_retired", "serve_steps",
            "serve_prefill_tokens", "serve_pages_free",
            "serve_pages_in_use", "serve_prefix_hit_tokens",
            "serve_prefix_lookup_tokens", "serve_prefix_hits",
            "serve_prefix_lookups", "serve_prefix_cached_pages",
            "serve_prefix_shared_pages", "serve_prefix_cow_copies",
            "serve_prefix_evicted_pages", "serve_prefix_hit_rate")
    return ({k: c[k] for k in keys}, sorted(eng._free_pages),
            eng._prefix.referenced_pages, eng._prefix.cached_pages,
            eng._prefix.shared_pages)


def test_same_traffic_as_the_jax_engine():
    """Shared-prefix, mixed-length traffic drained on the JAX engine and
    on the port's: equal token streams and exactly equal page, refcount
    and prefix-cache accounting, at a pool small enough to evict."""
    jm, jp, _, _ = tiny_pair()
    rs = np.random.RandomState(8)
    shared = [int(x) for x in rs.randint(2, 256, 20)]
    # the first registers three pages; the next two hit two of them and
    # copy the third on write; the distinct long prompts force evictions
    prompts = ([shared + [int(x) for x in rs.randint(2, 256, n)]
                for n in (9, 3, 1)]
               + _prompts(9, (7, 22, 30)))
    gens = (5, 3, 6, 4, 5, 10)
    kw = dict(slots=2, page_size=8, max_context=48, page_budget=64,
              max_queue=8, termination_id=None, vocab_size=256,
              prefill_chunk_tokens=16, step_horizon=2, prefix_cache=True)
    engines = [JaxEngine(jm, jp, **kw), _engine(**kw)]
    streams = []
    for eng in engines:
        first = _run(eng, prompts[:1], gens[:1], top_k=1)
        rest = _run(eng, prompts[1:], gens[1:], top_k=1)
        streams.append([[int(x) for x in toks] for toks, _ in first + rest])
    assert streams[0] == streams[1]
    assert _accounting(engines[0]) == _accounting(engines[1])
    c = engines[1].counters()
    assert c["serve_prefix_hits"] == 2 and c["serve_prefix_cow_copies"] == 2
    assert c["serve_prefix_evicted_pages"] > 0


def test_refusals():
    eng = _engine(max_queue=2)
    p = _prompts(5, (4,))[0]
    with pytest.raises(ValueError, match="max_context"):
        eng.submit(p, 61)
    a, b = eng.submit(p, 4), eng.submit(p, 4)
    with pytest.raises(QueueFull):
        eng.submit(p, 4)
    # cancel while queued: fails at once
    eng.cancel(b)
    with pytest.raises(RuntimeError, match="cancelled"):
        b.result(timeout=1)
    # cancel while running: reaped by the next round, pages come back
    eng.step()
    assert eng.counters()["serve_pages_in_use"] > 0
    eng.cancel(a)
    eng.drain()
    with pytest.raises(RuntimeError, match="cancelled"):
        a.result(timeout=1)
    c = eng.counters()
    assert c["serve_cancelled"] == 2 and c["serve_pages_in_use"] == 0
    # a deadline that has passed by the next round
    r = eng.submit(p, 4, deadline_s=1e-6)
    eng.drain()
    with pytest.raises(TimeoutError):
        r.result(timeout=1)
    assert eng.counters()["serve_timed_out"] == 1
    with pytest.raises(ValueError, match="deadline_s"):
        eng.submit(p, 4, deadline_s=0)


def test_sampled_request_depends_only_on_its_seed():
    """A sampled request with one seed gives the same tokens in slot 0
    alone and in slot 1 beside a greedy neighbour."""
    p = _prompts(6, (6,))[0]
    other = _prompts(7, (9,))[0]
    kw = dict(top_k=0, top_p=0.9, temperature=0.8, seed=1234)
    alone = _run(_engine(), [p], [8], **kw)[0][0]
    eng = _engine()
    g = eng.submit(other, 8, top_k=1)
    s = eng.submit(p, 8, **kw)
    eng.drain()
    assert s.result(5)[0] == alone and g.result(5)[0][:9] == other
    assert _run(_engine(), [p], [8], **{**kw, "seed": 99})[0][0] != alone


def test_per_row_top_p_threshold():
    logits = np.random.RandomState(1).randn(4, 50).astype(np.float32)
    rows = np.asarray([0.1, 0.5, 0.9, 1.0], np.float32)[:, None]
    got = modify_logits_for_top_p(t(logits), t(rows))
    ref = jax_top_p(jnp.asarray(logits), jnp.asarray(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for scalar in (0.3, 0.9):  # the scalar form keeps its results
        np.testing.assert_array_equal(
            modify_logits_for_top_p(t(logits), scalar).numpy(),
            np.asarray(jax_top_p(jnp.asarray(logits), scalar)))


def test_buckets_match_jax():
    from megatron_llm_tpu.inference import engine as jax_engine

    for h in (1, 2, 7, 8, 9):
        assert horizon_buckets(h) == jax_engine.horizon_buckets(h)
    for c in (0, 1, 8, 16, 100, 256):
        assert mixed_width_buckets(c) == jax_engine.mixed_width_buckets(c)
    eng = _engine(prefill_chunk_tokens=16)
    assert [eng._chunk_width(n) for n in (1, 3, 8, 9, 16, 40)] \
        == [1, 4, 8, 16, 16, 16]


@pytest.mark.parametrize("knob,value,slice_name", [
    ("prefill_chunk_tokens", 0, "whole-prompt admission"),
    ("spec_decode_k", 4, "speculative decoding"),
    ("kv_dtype", "int8", "quantized serving"),
    ("quantize_weights", True, "quantized serving"),
    ("window_reclaim", False, "sliding-window"),
    ("serving_tp", 2, "tp serving"),
    ("cost_registry", True, "observability"),
    ("trace_dir", "/nowhere", "observability"),
])
def test_left_out_knobs_name_their_slice(knob, value, slice_name):
    with pytest.raises(ValueError, match=slice_name):
        _engine(**{knob: value})


def test_serve_thread_and_health():
    eng = _engine()
    eng.start()
    try:
        reqs = [eng.submit(p, 3, top_k=1) for p in _prompts(2, (4, 6, 5))]
        outs = [r.result(timeout=60)[0] for r in reqs]
        assert eng.health()["alive"] and eng.health()["broken"] is None
    finally:
        eng.stop()
    assert not eng.health()["alive"]
    assert [len(o) for o in outs] == [7, 9, 8]
    assert torch.is_inference_mode_enabled() is False


def test_concurrent_submit_and_cancel_keep_the_accounting():
    """More client threads than cores submit and cancel against the
    serve thread with a short switch interval: every request finishes,
    and every page comes back."""
    import sys
    import threading

    eng = _engine(max_queue=64, prefix_cache=True, max_context=32)
    prompts = _prompts(13, [3 + i % 9 for i in range(24)])
    results, errors = [], []

    def client(i):
        try:
            r = eng.submit(prompts[i], 2 + i % 4, top_k=1)
            if i % 5 == 0:
                eng.cancel(r)
            try:
                results.append(len(r.result(timeout=60)[0]))
            except RuntimeError:
                results.append(None)  # cancelled
        except Exception as e:  # noqa: BLE001: reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    eng.start()
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(24)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    assert not errors and len(results) == 24
    c = eng.counters()
    # a cancelled request is cancelled once, queued or running; every
    # admitted request retires
    assert c["serve_cancelled"] == results.count(None) <= 5
    assert c["serve_admitted"] == c["serve_retired"] \
        >= 24 - c["serve_cancelled"]
    assert c["serve_queue_depth"] == 0 and c["serve_slot_occupancy"] == 0
    assert c["serve_pages_free"] + c["serve_prefix_cached_pages"] \
        == eng.num_pages - 1
