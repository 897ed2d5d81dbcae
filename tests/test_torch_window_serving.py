"""PyTorch port, sliding-window serving (a model's `attention_window_size`
and the engine's page reclamation) against the JAX engine on the CPU in
fp32, the oracles of tests/test_window_serving.py: reclamation ON gives
streams bitwise those of the mask-only engine (ON == OFF), and the JAX
engine's streams (log-probs within 1e-5) with exactly its reclaimed-page
and page accounting; a window covering the context is the plain engine;
a request whose reach overflows the pool serves in it; the prefix cache,
speculative decoding and int8 pools compose; the `/metrics` gate and
the refusals."""

import dataclasses

import numpy as np
import pytest

from megatron_llm_tpu.inference.engine import DecodeEngine as JaxEngine
from megatron_llm_tpu_torch.config import tiny_config
from megatron_llm_tpu_torch.inference.engine import DecodeEngine
from torch_parity import close, tiny_pair

BASE = dict(slots=2, page_size=16, max_context=64, prefill_chunk_tokens=16,
            vocab_size=256, termination_id=None)
TRAFFIC = [(range(5, 12), 12), (range(3, 6), 20), (range(2, 26), 36)]
MAX_POS = 256


def _pair(window):
    return tiny_pair(window=window, max_pos=MAX_POS)


def _engine(window, jax=False, **over):
    jm, jp, tm, tp = _pair(window)
    kw = dict(BASE, **over)
    return JaxEngine(jm, jp, **kw) if jax else DecodeEngine(tm, tp, **kw)


def _run(eng, specs, **submit):
    submit = submit or dict(top_k=1, return_log_probs=True)
    reqs = [eng.submit(list(p), g, **submit) for p, g in specs]
    eng.drain()
    return [(list(map(int, toks)), lps) for toks, lps in
            (r.result(30) for r in reqs)]


def _same_as_jax(got, ref):
    for i, ((gt, gl), (rt, rl)) in enumerate(zip(got, ref)):
        assert gt == rt, f"request {i}"
        if rl is not None:
            close(gl, rl, 1e-5, f"request {i} log-probs")


def _pages(eng):
    c = eng.counters()
    return (c["serve_pages_free"], c["serve_pages_in_use"],
            eng._window_reclaimed, sorted(eng._free_pages))


def test_reclaim_on_is_bitwise_off_and_matches_jax():
    """Window 24, mixed-length greedy traffic: reclamation ON equals the
    mask-only engine to the bit (tokens and log-probs), equals the JAX
    engine's streams, reclaims as many pages as JAX, and the window
    binds (the streams differ from the dense engine's)."""
    on = _engine(24)
    got_on = _run(on, TRAFFIC)
    off = _engine(24, window_reclaim=False)
    assert _run(off, TRAFFIC) == got_on
    jax_on = _engine(24, jax=True)
    _same_as_jax(got_on, _run(jax_on, TRAFFIC))
    assert on._window_reclaimed > 0 and off._window_reclaimed == 0
    assert _pages(on) == _pages(jax_on)
    assert _run(_engine(None), TRAFFIC) != got_on


def test_window_covering_context_is_the_plain_engine():
    win = _engine(4096)
    assert _run(win, TRAFFIC) == _run(_engine(None), TRAFFIC)
    assert win._window_reclaimed == 0


def test_long_request_serves_in_a_small_pool():
    """160 tokens of reach through a 6-page pool: the plain engine
    refuses at submit, the windowed one serves it, as JAX does, with
    the same stream and reclaimed pages, peak live pages within the
    window bound, and every page back at the end."""
    kw = dict(max_context=192, page_budget=96)
    with pytest.raises(ValueError, match="needs 10 pages"):
        _engine(None, **kw).submit(list(range(2, 10)), 152, top_k=1)
    eng, ref = _engine(48, **kw), _engine(48, jax=True, **kw)
    peak = []
    step = eng.step

    def counted():
        did = step()
        peak.append(max(s.mapped - s.reclaimed for s in eng._slots))
        return did
    eng.step = counted
    spec = [(range(2, 10), 152)]
    got = _run(eng, spec)
    _same_as_jax(got, _run(ref, spec))
    assert len(got[0][0]) == 8 + 152
    bound = eng._window_slot_pages()
    assert bound == ref._window_slot_pages() <= 5
    assert max(peak) <= bound
    assert eng._window_reclaimed == ref._window_reclaimed >= 10 - bound
    c = eng.counters()
    assert c["serve_pages_in_use"] == 0
    assert c["serve_pages_free"] == eng.num_pages - 1
    assert c["serve_window_reclaimed_pages"] == eng._window_reclaimed


def test_metrics_gate():
    """The window gauges appear only on windowed engines, with JAX's key
    set."""
    win, ref = _engine(32), _engine(32, jax=True)
    c = win.counters()
    assert c["serve_window_size"] == 32
    assert c["serve_window_reclaimed_pages"] == 0
    assert sorted(c) == sorted(k for k in ref.counters()
                               if k in c or k.startswith("serve_window"))
    assert not any(k.startswith("serve_window")
                   for k in _engine(None).counters())


def test_window_refusals():
    with pytest.raises(ValueError, match="chunked admission"):
        _engine(32, prefill_chunk_tokens=0)
    with pytest.raises(ValueError, match="attention_window_size"):
        tiny_config(attention_window_size=0)
    cfg = tiny_config(attention_window_size=64)
    assert dataclasses.replace(cfg).attention_window_size == 64


def test_prefix_cache_composition_matches_jax():
    """Shared prefix pages under a window: the reclaimer hands them back
    to the cache, never the free list; streams ON == OFF bitwise and
    equal to JAX's, with the same prefix and page accounting."""
    shared = list(range(4, 52))  # 3 full pages of shared prefix
    specs = [(shared + [90], 16), (shared + [91], 16), (shared + [92], 12)]
    kw = dict(max_context=128, prefix_cache=True)
    outs, engines = [], []
    for jax, reclaim in ((False, True), (False, False), (True, True)):
        eng = _engine(24, jax=jax, window_reclaim=reclaim, **kw)
        outs.append(_run(eng, specs, top_k=1))
        engines.append(eng)
    assert outs[0] == outs[1] == outs[2]
    keys = ("serve_prefix_hits", "serve_prefix_hit_tokens",
            "serve_prefix_cached_pages", "serve_pages_free")
    c, ref = engines[0].counters(), engines[2].counters()
    assert {k: c[k] for k in keys} == {k: ref[k] for k in keys}
    assert c["serve_prefix_hits"] > 0
    assert engines[0]._window_reclaimed == engines[2]._window_reclaimed > 0


def test_spec_decode_composition_matches_jax():
    """Drafts cap at the window edge; greedy verify keeps ON == OFF
    bitwise on repetitive traffic, with JAX's streams and acceptance."""
    prompt = [7, 8, 9, 10] * 6
    outs, engines = [], []
    for jax, reclaim in ((False, True), (False, False), (True, True)):
        eng = _engine(24, jax=jax, spec_decode_k=4, window_reclaim=reclaim)
        outs.append(_run(eng, [(prompt, 20)]))
        engines.append(eng)
    assert outs[0] == outs[1]
    _same_as_jax(outs[0], outs[2])
    keys = ("serve_spec_rounds", "serve_spec_proposed",
            "serve_spec_accepted")
    c, ref = engines[0].counters(), engines[2].counters()
    assert c["serve_spec_rounds"] > 0
    assert {k: c[k] for k in keys} == {k: ref[k] for k in keys}


def test_int8_composition_matches_jax():
    """int8 pools under a window of 40: scale pages are as unread as
    their data pages once reclaimed, so ON == OFF bitwise, and the
    streams are JAX's."""
    kw = dict(page_size=32, kv_dtype="int8")
    on = _run(_engine(40, **kw), TRAFFIC)
    assert on == _run(_engine(40, window_reclaim=False, **kw), TRAFFIC)
    _same_as_jax(on, _run(_engine(40, jax=True, **kw), TRAFFIC))
