"""PyTorch port, dropout across ranks (models/dropout.py and its sites).

A mask element is a hash of its site's seed and its global coordinates
(the sample's index in the step's global batch, its global position,
the feature, the global KV group and head), so every layout must draw
exactly its slice of world size 1's masks. One training step of a
4-layer Llama (fp32, SGD at lr 1 so that the update is the gradient)
on the same global batch of 2 microbatches of 4 rows, with hidden,
attention and LIMA dropout live (hidden only at cp, whose ring has no
attention dropout), at world size 1 in this process and at tp 2 with
and without sequence parallelism, dp 2, cp 2, pp 2 and tp 2 x dp 2 in
gloo CPU ranks:

- every mask a rank draws equals the same region of world size 1's
  mask of that site, bit for bit, and the ranks' masks cover it;
- the loss and the gradients (the SGD update, gathered whole) are
  within 1e-5 of world size 1's;
- the keep rate lies within 5 binomial sigmas of 1 - rate;
- under full recompute a rank draws the same masks again;
- attention dropout at cp > 1 raises, as in the JAX package.
"""

import numpy as np
import pytest
import torch

import torch_overlap_ranks as R
from megatron_llm_tpu_torch.utils.virtual_mesh import spawn_cpu_group

torch.set_num_threads(1)

LIVE = dict(hidden=0.1, attn=0.1, lima=True)
STEP = dict(steps=1, optimizer="sgd", lr=1.0, clip=0.0, wd=0.0, masks=True)
# name -> (layout, world); cp runs hidden dropout only
LAYOUTS = {
    "tp2": dict(tp=2), "tp2-sp": dict(tp=2, sp=True), "dp2": dict(dp=2),
    "cp2": dict(cp=2), "pp2": dict(pp=2),
    "tp2-dp2": dict(tp=2, dp=2, sp=True)}
TOL = 1e-5


def _opts(name):
    live = dict(hidden=0.1) if name.startswith("cp") else LIVE
    return dict(LAYOUTS[name], **live, **STEP)


@pytest.fixture(scope="module")
def runs():
    params, data = R.params_np(), R.batches(1, 2, 4)
    two = [n for n in LAYOUTS if n != "tp2-dp2"]
    jobs = [("train", (_opts(n), params, data)) for n in two]
    jobs += [("train", (dict(_opts("dp2"), remat="full"), params, data)),
             ("train_error", (dict(cp=2, attn=0.1, **STEP), params, data))]
    got2 = spawn_cpu_group(2, R.suite, jobs, timeout_s=600)
    got4 = spawn_cpu_group(4, R.suite, [
        ("train", (_opts("tp2-dp2"), params, data))], timeout_s=600)
    out = {n: [r[i] for r in got2] for i, n in enumerate(two)}
    out["tp2-dp2"] = [r[0] for r in got4]
    out["dp2-full"] = [r[len(two)] for r in got2]
    out["cp2-attention"] = got2[0][len(two) + 1]
    out["one"] = R.train(dict(LIVE, **STEP), params, data)
    out["one-hidden"] = R.train(dict(hidden=0.1, **STEP), params, data)
    out["params"] = params
    return out


def _whole(records):
    """seed -> (p, the global mask assembled from its pieces)."""
    extent, by_seed = {}, {}
    for seed, offs, shape, p, mask in records:
        offs = offs + (0,) * (len(shape) - len(offs))
        ext = tuple(o + n for o, n in zip(offs, shape))
        prev = extent.get(seed, ext)
        extent[seed] = tuple(max(a, b) for a, b in zip(prev, ext))
        by_seed.setdefault(seed, []).append((offs, mask, p))
    out = {}
    for seed, pieces in by_seed.items():
        whole = np.zeros(extent[seed], dtype=bool)
        for offs, mask, _ in pieces:
            whole[tuple(slice(o, o + n) for o, n in
                        zip(offs, mask.shape))] = mask
        out[seed] = (pieces[0][2], whole)
    return out


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_masks_are_slices_of_world_size_1(runs, name):
    one = _whole(runs["one-hidden" if name.startswith("cp")
                      else "one"]["masks"])
    covered = {seed: np.zeros(w.shape, dtype=bool)
               for seed, (_, w) in one.items()}
    drawn = 0
    for rank in runs[name]:
        for seed, offs, shape, p, mask in rank["masks"]:
            want_p, whole = one[seed]
            assert p == want_p
            offs = offs + (0,) * (len(shape) - len(offs))
            region = tuple(slice(o, o + n) for o, n in zip(offs, shape))
            np.testing.assert_array_equal(mask, whole[region])
            covered[seed][region] = True
            drawn += 1
    assert drawn > 0
    # the ranks drew every site's whole mask between them
    assert all(c.all() for c in covered.values())


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_loss_and_grads_match_world_size_1(runs, name):
    one = runs["one-hidden" if name.startswith("cp") else "one"]
    got = runs[name][0]
    np.testing.assert_allclose(got["log"][0]["loss"], one["log"][0]["loss"],
                               rtol=0, atol=TOL)

    def walk(a, b, p0):
        for k in b:
            if isinstance(b[k], dict):
                walk(a[k], b[k], p0[k])
            else:  # SGD at lr 1: the update is the gradient
                np.testing.assert_allclose(p0[k] - a[k], p0[k] - b[k],
                                           rtol=0, atol=TOL, err_msg=k)

    walk(got["params"], one["params"], runs["params"])


def test_keep_rate_within_binomial_bounds(runs):
    for rate, key in ((0.1, "one-hidden"),):
        masks = [m for *_, p, m in runs[key]["masks"]
                 if abs(p - (1 - rate)) < 1e-9]
        n = sum(m.size for m in masks)
        keep = sum(int(m.sum()) for m in masks) / n
        sigma = np.sqrt(rate * (1 - rate) / n)
        assert abs(keep - (1 - rate)) < 5 * sigma, (keep, n)
    # LIMA's ramp: each layer's hidden rate is 0.1 * i / (L - 1)
    rates = sorted({round(1 - p, 6) for *_, p, _ in runs["one"]["masks"]})
    assert 0.1 in rates and round(0.1 / 3, 6) in rates


def test_recompute_draws_the_same_masks(runs):
    plain = {(s, o, sh): m for r in runs["dp2"]
             for s, o, sh, _, m in r["masks"]}
    again = [(s, o, sh, m) for r in runs["dp2-full"]
             for s, o, sh, _, m in r["masks"]]
    # the recompute draws each mask a second time
    assert len(again) > len(plain)
    for s, o, sh, m in again:
        np.testing.assert_array_equal(m, plain[(s, o, sh)])
    assert runs["dp2-full"][0]["log"] == runs["dp2"][0]["log"]


def test_attention_dropout_at_cp_raises(runs):
    assert "attention_dropout == 0" in runs["cp2-attention"]
