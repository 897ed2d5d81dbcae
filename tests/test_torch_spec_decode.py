"""PyTorch port, speculative decoding in the engine (`spec_decode_k`, the
prompt-lookup drafter and the width-(k+1) verify round) against the JAX
engine on the CPU in fp32, the oracles of tests/test_spec_decode.py:
greedy streams equal to JAX `generate_tokens` and to the JAX spec engine
(log-probs within 1e-5) with equal `serve_spec_*` counts, on traffic
that accepts (a greedy cycle), that mostly rejects, with the prefix
cache, with an eod inside an accepted run, at the budget cap, with
whole-prompt admission's teacher-forced tail, and with a sampled request
beside greedy spec slots."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from megatron_llm_tpu.inference.engine import DecodeEngine as JaxEngine
from megatron_llm_tpu.inference.generation import (
    bucket_prefill_len,
    generate_tokens as jax_generate,
)
from megatron_llm_tpu_torch.inference.engine import DecodeEngine
from torch_parity import close, tiny_pair

# greedy continuations that fall into a cycle on the tiny model (probed):
# every draft accepts on the first, about half on the second
CYCLE_PROMPT = [77, 157, 136, 255]
PARTIAL_PROMPT = [108, 154, 251, 133]
BASE = dict(slots=2, page_size=16, max_context=64, max_queue=8,
            termination_id=None, vocab_size=256, prefill_chunk_tokens=8,
            spec_decode_k=4)
SPEC_KEYS = ("serve_spec_rounds", "serve_spec_proposed",
             "serve_spec_accepted", "serve_spec_accept_rate", "serve_steps",
             "serve_pages_free")


@functools.lru_cache(maxsize=None)
def _reference(prompt, gen, eod=None):
    """JAX `generate_tokens` alone on one prompt: (tokens, log-probs,
    length)."""
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


def _both(specs, sequential=False, submit=None, **over):
    """The traffic on the JAX engine and on the port's: both engines and
    both lists of (tokens, log-probs)."""
    jm, jp, tm, tp = tiny_pair()
    kw = dict(BASE, **over)
    submit = submit or dict(top_k=1, return_log_probs=True)
    engines = [JaxEngine(jm, jp, **kw), DecodeEngine(tm, tp, **kw)]
    outs = []
    for eng in engines:
        groups = [[s] for s in specs] if sequential else [specs]
        res = []
        for grp in groups:
            reqs = [eng.submit(list(p), g, **submit) for p, g in grp]
            eng.drain()
            res += [r.result(30) for r in reqs]
        outs.append([(list(map(int, toks)), lps) for toks, lps in res])
    return engines, outs


def _assert_same(engines, outs):
    (jout, pout) = outs
    for i, ((jt, jl), (pt_, pl)) in enumerate(zip(jout, pout)):
        assert pt_ == jt, f"request {i}"
        if jl is not None:
            close(pl, jl, 1e-5, f"request {i} log-probs")
    jc, pc = (e.counters() for e in engines)
    assert {k: pc[k] for k in SPEC_KEYS} == {k: jc[k] for k in SPEC_KEYS}
    return pc


@pytest.mark.parametrize("k", [1, 2, 4])
def test_cycle_traffic_accepts_and_matches_jax(k):
    """Drafts accept on the greedy cycle: the stream equals JAX
    `generate_tokens` alone and the JAX spec engine's, with its
    acceptance counts, in fewer rounds than tokens."""
    engines, outs = _both([(CYCLE_PROMPT, 40)], spec_decode_k=k)
    c = _assert_same(engines, outs)
    ref_toks, ref_lp, _ = _reference(tuple(CYCLE_PROMPT), 40)
    toks, lps = outs[1][0]
    assert toks == ref_toks
    close(lps, ref_lp[:len(toks) - 1], 1e-5)
    assert c["serve_spec_accepted"] > 0 and c["serve_steps"] < 4 + 40


def test_rejections_keep_the_streams():
    """Traffic whose drafts mostly reject (repeated bigrams in the prompt
    the model does not continue), beside a partly accepting cycle."""
    rs = np.random.RandomState(11)
    specs = [(list(rs.randint(2, 256, 5)) * 2, 8),
             (list(rs.randint(2, 256, 9)), 8), ([7, 8] * 6, 8),
             (PARTIAL_PROMPT, 40)]
    engines, outs = _both(specs, spec_decode_k=3)
    c = _assert_same(engines, outs)
    assert c["serve_spec_proposed"] > c["serve_spec_accepted"] > 0
    for (p, g), (toks, _) in zip(specs, outs[1]):
        assert toks == _reference(tuple(int(x) for x in p), g)[0]


def test_spec_composes_with_prefix_sharing():
    rs = np.random.RandomState(12)
    sysp = [int(x) for x in rs.randint(2, 256, 32)]
    specs = [(sysp + CYCLE_PROMPT, 20),
             (sysp + [int(x) for x in rs.randint(2, 256, 3)], 12)]
    engines, outs = _both(specs, sequential=True, submit=dict(top_k=1),
                          prefix_cache=True)
    c = _assert_same(engines, outs)
    assert c["serve_prefix_hit_tokens"] >= 32
    assert c["serve_prefix_hit_tokens"] \
        == engines[0].counters()["serve_prefix_hit_tokens"]


def test_eod_inside_an_accepted_run():
    """An eod inside an accepted run retires the slot there: the booked
    stream is the reference's eod-truncated one."""
    free, _, _ = _reference(tuple(CYCLE_PROMPT), 40)
    eod = free[len(CYCLE_PROMPT) + 12]
    engines, outs = _both([(CYCLE_PROMPT, 40)], termination_id=eod)
    _assert_same(engines, outs)
    ref_toks, _, n = _reference(tuple(CYCLE_PROMPT), 40, eod)
    assert outs[1][0][0] == ref_toks[:n] and outs[1][0][0][-1] == eod


@pytest.mark.parametrize("gen", [1, 2, 5])
def test_budget_cap_books_exactly(gen):
    engines, outs = _both([(CYCLE_PROMPT, gen), (PARTIAL_PROMPT, gen + 3)])
    _assert_same(engines, outs)
    assert [len(t) - 4 for t, _ in outs[1]] == [gen, gen + 3]


def test_whole_prompt_tail_is_forced_before_drafting():
    """Whole-prompt admission teacher-forces the prompt past its bucket;
    no verify round runs while a slot owes forced tokens."""
    rs = np.random.RandomState(5)
    specs = [([int(x) for x in rs.randint(2, 256, 9)] + CYCLE_PROMPT, 24),
             (PARTIAL_PROMPT * 2, 20)]
    engines, outs = _both(specs, prefill_chunk_tokens=0)
    c = _assert_same(engines, outs)
    assert c["serve_spec_rounds"] > 0


def test_sampled_request_rides_spec_rounds():
    """A sampled request is a plain decode row of the verify rounds: its
    tokens are the ones it gets alone on an engine without spec, and the
    greedy neighbour's stream is the reference."""
    _, _, tm, tp = tiny_pair()
    kw = dict(top_k=0, top_p=0.9, temperature=0.8, seed=7)
    alone = DecodeEngine(tm, tp, **dict(BASE, spec_decode_k=0))
    r = alone.submit(PARTIAL_PROMPT, 12, **kw)
    alone.drain()
    eng = DecodeEngine(tm, tp, **BASE)
    g = eng.submit(CYCLE_PROMPT, 30, top_k=1)
    s = eng.submit(PARTIAL_PROMPT, 12, **kw)
    eng.drain()
    assert s.result(5)[0] == r.result(5)[0]
    assert g.result(5)[0] == _reference(tuple(CYCLE_PROMPT), 30)[0]
    assert eng.counters()["serve_spec_accepted"] > 0
