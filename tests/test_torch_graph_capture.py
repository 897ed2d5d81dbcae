"""PyTorch port, round capture (inference/graph_capture.py) on the CPU in
fp32, where each runner calls its round eagerly on the static buffers the
card replays: the static-buffer engine gives the streams and the page and
refcount accounting of an engine that calls each round directly on fresh
tensors and of the JAX engine in every ported mode; `warmup()` mints
every bucket and, on the port and on the JAX engine, leaves pools,
lengths, page table, carried logits and prefix cache as they were;
nothing a captured round or the whole-batch step runs reads the card on
the host; the whole-batch step with its device offset equals JAX
`generate_tokens`, and a step replayed past the end changes nothing; a
sampled stream is a function of its seed; a whole-batch call keeps
nothing of its decode once it returns."""

import gc as gc_mod
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from megatron_llm_tpu.inference import generation as jax_gen
from megatron_llm_tpu.inference.engine import DecodeEngine as JaxEngine
from megatron_llm_tpu_torch.inference import generation as pt_gen
from megatron_llm_tpu_torch.inference import graph_capture as gc
from megatron_llm_tpu_torch.inference.engine import (
    DecodeEngine,
    horizon_buckets,
    mixed_width_buckets,
)
from torch_parity import close, tiny_pair

BASE = dict(slots=2, page_size=16, max_context=64, max_queue=8,
            termination_id=None, vocab_size=256, prefill_chunk_tokens=8)
# greedy continuations of these prompts cycle on the tiny model, so
# drafts accept (tests/test_torch_spec_decode.py)
CYCLE_PROMPT = [77, 157, 136, 255]


def _prompts(seed, lens):
    rs = np.random.RandomState(seed)
    return [[int(x) for x in rs.randint(2, 256, n)] for n in lens]


# mode -> (tiny_pair kwargs, engine kwargs, (prompt, gen) traffic); the
# int8 and whole-prompt traffic seeds are those of
# tests/test_torch_quantization.py, whose K/V meet no rounding tie
MODES = {
    "fp": ({}, {}, list(zip(_prompts(0, (5, 9, 3, 17)), (6, 4, 8, 5)))),
    "int8_weights": ({}, dict(kv_dtype="int8", quantize_weights=True),
                     list(zip(_prompts(1, (5, 9, 3, 17)), (6, 4, 8, 5)))),
    "window": (dict(window=24, max_pos=256),
               dict(prefill_chunk_tokens=16),
               [(list(range(5, 12)), 12), (list(range(3, 6)), 20),
                (list(range(2, 26)), 36)]),
    "spec": ({}, dict(spec_decode_k=4),
             [(CYCLE_PROMPT, 40)]
             + list(zip(_prompts(2, (6, 11)), (8, 6)))),
    "whole_prompt": ({}, dict(prefill_chunk_tokens=0, max_context=80),
                     list(zip(_prompts(1, (5, 9, 3, 17, 70)),
                              (6, 4, 8, 5, 3)))),
}
ACCOUNTING = ("serve_admitted", "serve_retired", "serve_steps",
              "serve_prefill_tokens", "serve_pages_free",
              "serve_pages_in_use")


class _DirectEngine(DecodeEngine):
    """Calls each round's function directly on fresh device tensors of
    the round's host arrays: no runner, no static buffers."""

    def _capture(self, step, null_args, **static):
        def run(**host):
            return step(self.model, self._dec_params, self._pools,
                        self._last_logits, vocab_size=self.vocab_size,
                        **static, **{k: self._dev(v) for k, v in host.items()})
        return run


@pytest.fixture
def loops(monkeypatch):
    """The whole-batch decode loops made while the test runs, in order."""
    made = []

    class Recorded(pt_gen._DecodeLoop):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(pt_gen, "_DecodeLoop", Recorded)
    return made


def _drain(eng, traffic, **submit):
    submit = submit or dict(top_k=1, return_log_probs=True)
    reqs = [eng.submit(list(p), g, **submit) for p, g in traffic]
    eng.drain()
    return [([int(x) for x in toks], lps) for toks, lps in
            (r.result(timeout=30) for r in reqs)]


def _accounting(eng):
    c = eng.counters()
    extra = {k: c[k] for k in c if k.startswith(("serve_spec_",
                                                 "serve_window_"))}
    return ({k: c[k] for k in ACCOUNTING}, extra, sorted(eng._free_pages))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_static_buffer_engine_equals_eager_and_jax(mode):
    """The same traffic through the engine whose rounds run on the
    runners' static buffers, through an engine that calls each round
    directly on fresh tensors and through the JAX engine: equal greedy
    streams, log-probs bitwise between the two port paths and within
    1e-5 of JAX, exactly equal page and refcount accounting."""
    pair_kw, over, traffic = MODES[mode]
    jm, jp, tm, tp = tiny_pair(**pair_kw)
    kw = dict(BASE, **over)
    captured = DecodeEngine(tm, tp, **kw)
    eager = _DirectEngine(tm, tp, **kw)
    jax_eng = JaxEngine(jm, jp, **kw)
    got = _drain(captured, traffic)
    assert all(isinstance(r, gc.CapturedFn)
               for r in captured._step_fns.values()) and captured._step_fns
    ref = _drain(eager, traffic)
    assert [t for t, _ in got] == [t for t, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert _accounting(captured) == _accounting(eager)
    jref = _drain(jax_eng, traffic)
    for i, ((t, lp), (jt, jlp)) in enumerate(zip(got, jref)):
        assert t == [int(x) for x in jt], f"request {i}"
        close(lp, jlp, 1e-5, f"request {i} log-probs")
    assert _accounting(captured) == _accounting(jax_eng)
    if mode == "spec":
        assert captured.counters()["serve_spec_accepted"] > 0
        assert captured._spec_fns
    if mode == "window":
        assert captured._window_reclaimed > 0


def test_sampled_streams_of_both_port_paths_are_equal():
    """A sampled request beside a greedy one: the runner engine and the
    engine calling each round directly give the same streams (the draw
    is a function of seed and step, on the card and on the host
    alike)."""
    _, _, tm, tp = tiny_pair()
    outs = []
    for engine in (DecodeEngine, _DirectEngine):
        eng = engine(tm, tp, **BASE)
        s = eng.submit(_prompts(6, (6,))[0], 8, top_k=0, top_p=0.9,
                       temperature=0.8, seed=1234)
        g = eng.submit(_prompts(7, (9,))[0], 8, top_k=1)
        eng.drain()
        outs.append((s.result(5)[0], g.result(5)[0]))
    assert outs[0] == outs[1]


def _port_state(eng):
    pools = [p[1:].clone() for group in eng._pools for p in group]
    prefix = None if eng._prefix is None else (
        eng._prefix.stats(), eng._prefix.referenced_pages,
        eng._prefix.cached_pages)
    return (pools, eng._lengths.copy(), eng._pt.copy(),
            eng._last_logits.clone(), sorted(eng._free_pages), prefix)


def _same_state(a, b):
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    assert torch.equal(a[3], b[3])
    assert a[4:] == b[4:]


@pytest.mark.parametrize("spec", [0, 4], ids=["chunked", "spec"])
def test_warmup_mints_every_bucket_and_is_invisible(spec):
    """`warmup()` in the middle of traffic (live slots, registered prefix
    pages): the minted keys are every horizon and mixed-width bucket
    (and the verify width) with both greedy flags, pools past the null
    page, lengths, page table, carried logits, free list and prefix
    cache are bitwise unchanged, and the streams equal an engine that
    never warmed up."""
    _, _, tm, tp = tiny_pair()
    kw = dict(BASE, step_horizon=4, prefix_cache=True, spec_decode_k=spec)
    traffic = list(zip(_prompts(3, (12, 20, 7)), (6, 9, 5)))
    warmed = DecodeEngine(tm, tp, **kw)
    reqs = [warmed.submit(p, g, top_k=1) for p, g in traffic]
    for _ in range(4):
        warmed.step()
    assert any(s.req is not None for s in warmed._slots)
    before = _port_state(warmed)
    warmed.warmup()
    _same_state(before, _port_state(warmed))
    flags = (True, False)
    assert set(warmed._step_fns) == {(h, g) for h in horizon_buckets(4)
                                     for g in flags}
    assert set(warmed._mixed_fns) == {(w, g) for w in mixed_width_buckets(8)
                                      for g in flags}
    assert set(warmed._spec_fns) == ({(spec + 1, g) for g in flags}
                                     if spec else set())
    warmed.drain()
    plain = DecodeEngine(tm, tp, **kw)
    assert [r.result(5)[0] for r in reqs] == \
        [t for t, _ in _drain(plain, traffic, top_k=1)]


def test_jax_warmup_is_invisible():
    """The JAX engine's warmup (the reference of the port's): pools past
    the null page, lengths and page table unchanged mid-traffic."""
    jm, jp, _, _ = tiny_pair()
    eng = JaxEngine(jm, jp, **dict(BASE, step_horizon=2,
                                   prefill_chunk_tokens=4))
    for p, g in zip(_prompts(3, (12, 7)), (6, 5)):
        eng.submit(p, g, top_k=1)
    for _ in range(3):
        eng.step()

    def state():
        pools = [np.asarray(p)[1:] for p in eng._pools_k + eng._pools_v]
        return pools, eng._lengths.copy(), eng._pt.copy()

    before = state()
    eng.warmup()
    after = state()
    for x, y in zip(before[0], after[0]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(before[1], after[1])
    np.testing.assert_array_equal(before[2], after[2])
    eng.drain()


class _NoHostReads(TorchDispatchMode):
    """Raises on every op that reads a tensor's value on the host."""

    BANNED = ("_local_scalar_dense", "item", "nonzero")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.BANNED:
            raise AssertionError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", ["fp", "int8_weights", "window", "spec"])
def test_captured_rounds_read_nothing_on_the_host(mode):
    """Every round a warmed-up engine minted (decode, mixed and verify,
    greedy and sampled) runs through without a host read: what is
    captured on the card has no sync inside."""
    pair_kw, over, _ = MODES[mode]
    _, _, tm, tp = tiny_pair(**pair_kw)
    eng = DecodeEngine(tm, tp, **dict(BASE, step_horizon=2, **over))
    eng.warmup()
    runners = [*eng._step_fns.values(), *eng._mixed_fns.values(),
               *eng._spec_fns.values()]
    assert runners
    with torch.inference_mode(), _NoHostReads():
        for r in runners:
            r.fn(**r.inputs)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_whole_batch_step_reads_nothing_on_the_host(sampled, loops):
    _, _, tm, tp = tiny_pair()
    toks = np.zeros((2, 24), np.int64)
    toks[:, :5] = _prompts(4, (5, 5))
    kw = dict(prefill_len=4, vocab_size=250, termination_id=3,
              return_log_probs=True)
    if sampled:
        kw.update(generator=torch.Generator().manual_seed(1), top_p=0.9,
                  top_p_decay=0.9, top_p_bound=0.5, temperature=0.8)
    else:
        kw.update(top_k=1)
    pt_gen.generate_tokens(tm, tp, toks, [5, 4], **kw)
    loop = loops[-1]
    with torch.inference_mode():
        loop.t.fill_(6)
        with _NoHostReads():
            loop._step()


def _eod_in_stream(jm, jp, prompt, at):
    out = jax_gen.generate_tokens(
        jm, jp, jnp.asarray([prompt + [0] * 40]), jnp.asarray([len(prompt)]),
        prefill_len=len(prompt), top_k=1, vocab_size=256)
    return int(np.asarray(out.tokens)[0, len(prompt) + at])


@pytest.mark.parametrize("eod", [False, True], ids=["to_max_len", "eod"])
def test_device_offset_step_equals_jax_and_idles_past_the_end(eod, loops):
    """Greedy decode of a ragged batch (to max_len) and of one row that
    stops early at eod: tokens, lengths and log-probs equal JAX's; the
    host saw the stop at a multiple of the check interval, and steps
    replayed after the end change no output."""
    jm, jp, tm, tp = tiny_pair()
    if eod:
        prompt = _prompts(5, (5,))[0]
        term = _eod_in_stream(jm, jp, prompt, 3)
        toks = np.zeros((1, 45), np.int32)
        toks[0, :5] = prompt
        lens = np.asarray([5], np.int32)
    else:
        term = None
        toks = np.zeros((3, 20), np.int32)
        for i, p in enumerate(_prompts(6, (4, 7, 5))):
            toks[i, :len(p)] = p
        lens = np.asarray([4, 7, 5], np.int32)
    kw = dict(prefill_len=4, top_k=1, vocab_size=256, termination_id=term,
              return_log_probs=True)
    ref = jax_gen.generate_tokens(jm, jp, jnp.asarray(toks),
                                  jnp.asarray(lens), **kw)
    got = pt_gen.generate_tokens(tm, tp, toks, lens, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(ref.lengths))
    close(got.log_probs, ref.log_probs, 1e-5)
    loop = loops[-1]
    if eod:
        assert int(got.lengths[0]) < 45 and bool(loop.done.all())
        assert int(loop.t) < 45  # stopped before max_len
    else:
        assert int(loop.t) == 20
    state = [x.clone() for x in (loop.tokens, loop.log_probs,
                                 loop.gen_lens, loop.done, loop.t,
                                 loop.last_logits)]
    with torch.inference_mode():
        for _ in range(3):
            loop.step()
    for a, b in zip(state, (loop.tokens, loop.log_probs, loop.gen_lens,
                            loop.done, loop.t, loop.last_logits)):
        assert torch.equal(a, b)


def test_whole_batch_sampled_stream_is_a_function_of_its_seed():
    """Seeds 5, 6 and 5 again: the two seed-5 streams are equal and equal
    the uncaptured path's; seed 6 differs."""
    _, _, tm, tp = tiny_pair()
    toks = np.zeros((2, 20), np.int64)
    toks[:, :4] = _prompts(7, (4, 4))

    def run(seed, eager=False):
        gen = torch.Generator().manual_seed(seed)
        return pt_gen.generate_tokens(
            tm, tp, toks, [4, 4], prefill_len=4, generator=gen, top_p=0.9,
            top_p_decay=0.9, top_p_bound=0.5, temperature=0.8,
            vocab_size=250, _eager=eager).tokens.numpy()

    a, b, c = run(5), run(6), run(5)
    np.testing.assert_array_equal(a, c)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, run(5, eager=True))


def test_whole_batch_call_keeps_nothing_of_its_decode(loops):
    """Three calls at different (batch, max_len): each one's loop, with
    its caches and its step's runner, is freed as the call returns (no
    reference cycle waits for the garbage collector), and the log holds
    one record a call with its steps and its caches' bytes."""
    _, _, tm, tp = tiny_pair()
    gc_mod.disable()
    try:
        for b, max_len in ((1, 12), (3, 20), (2, 33)):
            toks = np.zeros((b, max_len), np.int64)
            toks[:, :4] = _prompts(b, (4,) * b)
            pt_gen.generate_tokens(tm, tp, toks, [4] * b, prefill_len=4,
                                   top_k=1, vocab_size=250)
            loop = weakref.ref(loops.pop())
            assert loop() is None, (b, max_len)
            rec = pt_gen.decode_log[-1]
            assert (rec["batch"], rec["max_len"], rec["steps"]) == \
                (b, max_len, max_len - 4)
            cfg = tm.cfg
            itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
            assert rec["cache_bytes"] == 2 * cfg.num_layers * b * max_len \
                * cfg.num_query_groups * cfg.head_dim * itemsize
    finally:
        gc_mod.enable()


def test_launch_counts_add_and_restore():
    """The replay bookkeeping: a delta added to the kernels' counters
    (K7's by variant too) and taken away again."""
    before = gc.launch_counts()
    delta = {"decode_attention": 3, "ragged_paged_attention": 2,
             "ragged_paged_attention:tc": 2, "fused_rms_norm": 5}
    gc.add_launch_counts(delta)
    after = gc.launch_counts()
    assert {k: after[k] - before[k] for k in delta} == delta
    gc.add_launch_counts({k: -v for k, v in delta.items()})
    assert gc.launch_counts() == before
