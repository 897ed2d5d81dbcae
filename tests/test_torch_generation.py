"""PyTorch port, generation against the JAX package on shared weights
(fp32, CPU): greedy `generate_tokens` tokens equal and log-probs within
1e-5 on ragged prompts with eod termination, `score_tokens`,
`beam_search`, the top-k / top-p logit masks, and seeded sampling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.inference import generation as jax_gen
from megatron_llm_tpu.inference import sampling as jax_sampling
from megatron_llm_tpu_torch.inference import generation as pt_gen
from megatron_llm_tpu_torch.inference import sampling as pt_sampling
from torch_parity import close, t, tiny_pair


def _ragged_batch(seed=11, lens=(5, 9, 3, 17), max_len=64):
    rs = np.random.RandomState(seed)
    toks = np.zeros((len(lens), max_len), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rs.randint(2, 250, n)
    return toks, np.asarray(lens, np.int32)


def _eod_in_stream(jm, jp, toks, lens):
    """A token the first row greedily emits mid-stream: used as eod so
    that row terminates early while the others run on."""
    out = jax_gen.generate_tokens(
        jm, jp, jnp.asarray(toks[:1]), jnp.asarray(lens[:1]),
        prefill_len=int(lens[0]), top_k=1, vocab_size=256)
    return int(np.asarray(out.tokens)[0, lens[0] + 3])


def test_generate_greedy_matches_jax_with_eod():
    """Ragged prompts (the rows past the bucketed prefill are
    teacher-forced) and an eod one row emits early; the JAX side's decode
    steps run the real Pallas kernel under the interpreter."""
    jm, jp, tm, tp = tiny_pair(jax_kernel=True)
    toks, lens = _ragged_batch()
    eod = _eod_in_stream(jm, jp, toks, lens)
    prefill = jax_gen.bucket_prefill_len(int(lens.min()))
    kw = dict(prefill_len=prefill, top_k=1, vocab_size=250,
              termination_id=eod, return_log_probs=True)
    ref = jax_gen.generate_tokens(jm, jp, jnp.asarray(toks),
                                  jnp.asarray(lens), **kw)
    got = pt_gen.generate_tokens(tm, tp, toks, lens, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(ref.lengths))
    assert got.lengths[0] < 64, "eod must end the first row early"
    close(got.log_probs, ref.log_probs, 1e-5)


def test_generate_runs_to_max_len_without_eod():
    jm, jp, tm, tp = tiny_pair()
    toks, lens = _ragged_batch(seed=12, lens=(4, 6), max_len=20)
    kw = dict(prefill_len=4, top_k=1, return_log_probs=True,
              termination_id=None)
    ref = jax_gen.generate_tokens(jm, jp, jnp.asarray(toks),
                                  jnp.asarray(lens), **kw)
    got = pt_gen.generate_tokens(tm, tp, toks, lens, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    close(got.log_probs, ref.log_probs, 1e-5)


def test_score_tokens():
    jm, jp, tm, tp = tiny_pair()
    toks = np.random.RandomState(13).randint(0, 256, (3, 12)).astype(np.int32)
    got = pt_gen.score_tokens(tm, tp, toks)
    ref = jax_gen.score_tokens(jm, jp, jnp.asarray(toks))
    close(got, ref, 1e-5)


def test_beam_search_matches_jax():
    jm, jp, tm, tp = tiny_pair()
    toks = np.zeros((1, 64), np.int32)
    toks[0, :6] = np.random.RandomState(14).randint(2, 250, 6)
    kw = dict(prompt_length=6, beam_size=3, stop_token=0, num_return_gen=3,
              vocab_size=250, max_new_tokens=10)
    ref_toks, ref_scores = jax_gen.beam_search(jm, jp, jnp.asarray(toks), **kw)
    got_toks, got_scores = pt_gen.beam_search(tm, tp, toks, **kw)
    np.testing.assert_array_equal(got_toks, np.asarray(ref_toks))
    close(got_scores, ref_scores, 1e-5)


@pytest.mark.parametrize("top_k", [1, 3, 40])
def test_top_k_mask(top_k):
    logits = np.random.RandomState(top_k).randn(4, 300).astype(np.float32)
    got = pt_sampling.modify_logits_for_top_k(t(logits), top_k)
    ref = jax_sampling.modify_logits_for_top_k(jnp.asarray(logits), top_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9, 0.95])
def test_top_p_mask(top_p):
    logits = 3 * np.random.RandomState(7).randn(4, 300).astype(np.float32)
    got = pt_sampling.modify_logits_for_top_p(t(logits), top_p)
    ref = jax_sampling.modify_logits_for_top_p(jnp.asarray(logits),
                                               jnp.float32(top_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_select_next_token_masks_pad_vocab_and_newline_after_colon():
    logits = np.zeros((2, 8), np.float32)
    logits[:, 7] = 5.0  # a padded-vocab id
    logits[:, 3] = 4.0  # "newline"
    logits[:, 2] = 3.0
    prev = np.asarray([1, 9])  # row 0 follows a "colon" (id 1)
    kw = dict(greedy=True, top_k=1, top_p=0.0, temperature=1.0,
              vocab_size=7, prevent_newline_after_colon_ids=(1, 3))
    got = pt_gen.select_next_token(t(logits), t(prev), None, 0.0, **kw)
    ref = jax_gen.select_next_token(jnp.asarray(logits), jnp.asarray(prev),
                                    None, 0.0, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.tolist() == [2, 3]


def test_sampled_generation_is_seed_stable():
    """A sampled request seeded twice returns the same tokens; another
    seed returns other tokens; top-p decay runs."""
    _, _, tm, tp = tiny_pair()
    toks, lens = _ragged_batch(seed=15, lens=(4, 7), max_len=32)

    def run(seed):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        return pt_gen.generate_tokens(
            tm, tp, toks, lens, prefill_len=4, generator=gen, top_p=0.9,
            top_p_decay=0.9, top_p_bound=0.5, temperature=0.8,
            vocab_size=250).tokens.numpy()

    a, b, c = run(5), run(5), run(6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    np.testing.assert_array_equal(a[0, :4], toks[0, :4])
    assert a[:, 7:].max() < 250
