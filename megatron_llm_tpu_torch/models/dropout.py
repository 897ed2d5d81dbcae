"""Dropout with masks hashed from derived seeds and global coordinates
(the port's form of the JAX package's `jax.random` key stream for
dropout).

The JAX package folds and splits one key down the model: the trainer's
base key `seed + 1` folded with the iteration (training/trainer.py
:991-997), split between the embedding and the stack
(language_model.py), folded with the layer index and split three ways
inside a layer (transformer.py:176-180). Here a stream is a 63-bit
integer seed and `fold_in` / `split` mix it with the same data, so every
site's seed is a pure function of (base seed, iteration, layer, site).

A mask element is an integer hash, in torch ops, of the site's seed and
the element's global coordinates (`bernoulli`): for a hidden activation
(b, s, h) the sample's index in the step's global batch, its global
position and the feature; for attention probabilities (b, g, qpk, s, t)
the sample, the global KV group, the head within it and the two
positions. A `Stream` carries the seed and the global offsets of the
leading axes of the rank's slice (the sample and the position: its dp
rows of the global microbatch, its cp shard), and each site adds what
its own layout cuts (the sequence-parallel shard, the tp rank's groups).
So every layout draws exactly its slice of world size 1's mask, and
ranks that hold a replicated activation draw the same whole mask. A
recomputed layer (models/remat.py) draws the same masks again, as it
derives the same seeds. Only the last axis is hashed over the whole
shape, in two products of 30-bit row keys and 32-bit column keys and one
mask (`bernoulli`); every value stays below 2^63, so the CPU's and the
card's bits are the same. The bits are the port's, not jax.random's.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Tuple, Union

import torch

from megatron_llm_tpu_torch.parallel.mesh import get_context

_MASK64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF
# the hash's multiplier, below 2^31: (2^32 - 1) * it stays below 2^63
_MUL = 0x045D9F3B
_GOLDEN = 0x9E3779B9
# odd multipliers below 2^31 that make the second row and column keys
_KEY2_ROW, _KEY2_COL = 0x2545F491, 0x2C1B3C6D
_M30 = (1 << 30) - 1
_M40 = (1 << 40) - 1


def _mix(z: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit integers."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


@dataclass(frozen=True)
class Stream:
    """A dropout stream: the seed and the global offsets of the leading
    axes of the tensor the rank holds (by default (sample, position))."""

    seed: int
    offsets: Tuple[int, ...] = ()


SeedLike = Union[int, Stream]


def _seed(s: SeedLike) -> int:
    return s.seed if isinstance(s, Stream) else int(s)


def _with_seed(s: SeedLike, seed: int) -> SeedLike:
    return replace(s, seed=seed) if isinstance(s, Stream) else seed


def fold_in(seed: SeedLike, data: int) -> SeedLike:
    """The stream `seed` folded with the integer `data`
    (jax.random.fold_in); a `Stream` keeps its offsets."""
    return _with_seed(seed, _mix(_seed(seed) ^ _mix(int(data) & _MASK64))
                      >> 1)


def split(seed: SeedLike, n: int = 2) -> tuple:
    """n streams derived from `seed` (jax.random.split), apart from any
    `fold_in(seed, i)`."""
    base = _seed(seed)
    return tuple(_with_seed(seed, _mix(_mix(base) + 2 * i + 1) >> 1)
                 for i in range(n))


def at(stream: SeedLike, *offsets: int) -> Stream:
    """The stream with the global offsets of each leading axis of a
    site's tensor (trailing axes start at 0)."""
    return Stream(_seed(stream), tuple(int(o) for o in offsets))


def offsets_of(stream: SeedLike) -> Tuple[int, ...]:
    return stream.offsets if isinstance(stream, Stream) else ()


def _sample_position(stream: SeedLike) -> Tuple[int, int]:
    offs = offsets_of(stream) + (0, 0)
    return offs[0], offs[1]


def hidden_site(stream, seq_len: int):
    """The stream of a hidden-state site, (b, s, h): under sequence
    parallelism the rank holds the tp rank's chunk of its s positions.
    None for no stream."""
    if stream is None:
        return None
    sample, pos = _sample_position(stream)
    ctx = get_context()
    if ctx is not None and ctx.sequence_parallel:
        pos += ctx.tp_rank * seq_len
    return at(stream, sample, pos)


def attention_site(stream, groups: int):
    """The stream of the attention probabilities, (b, g, qpk, s, t):
    under tensor parallelism the rank holds `groups` consecutive KV
    groups from tp_rank * groups. None for no stream."""
    if stream is None:
        return None
    sample, pos = _sample_position(stream)
    ctx = get_context()
    g0 = ctx.tp_rank * groups if ctx is not None and ctx.tp > 1 else 0
    return at(stream, sample, g0, 0, pos, 0)


def _hash32(z):
    """A 32-bit integer hash (two multiply-xorshift rounds) of values in
    [0, 2^32): python ints or int64 tensors, the same bits."""
    z = (((z >> 16) ^ z) * _MUL) & _M32
    z = (((z >> 16) ^ z) * _MUL) & _M32
    return (z >> 16) ^ z


@functools.lru_cache(maxsize=256)
def _coords(n: int, off: int, device: torch.device) -> torch.Tensor:
    """The hashes of global coordinates off .. off + n - 1, each hashed
    on its own so that rows whose hashes are close never draw shifted
    copies of one sequence; kept, as they do not depend on the seed."""
    return _hash32((torch.arange(n, dtype=torch.int64, device=device)
                    + off + _GOLDEN) & _M32)


def bernoulli(seed: SeedLike, p: float, shape, device) -> torch.Tensor:
    """A bool mask of `shape`, True with probability `p`
    (jax.random.bernoulli). Coordinates are global: i_j + offset_j (the
    stream's offsets, 0 past them). The leading axes are hashed in order
    into a row key, h = hash(seed), then h = hash(h ^ hash(c_j)), on a
    (..., 1) tensor; the last axis into a column key hash(hash(c_k) ^
    hash(seed)). Element (i_0, ..., i_k) draws bits 8..39 of r1 c1 + r2 c2
    (r1, r2 odd 30-bit numbers from the row key and the row key times a
    constant, c1 the column key, c2 its product with another constant cut
    to 32 bits: each product below 2^62) and is kept where the draw falls
    below p * 2^32. Over the whole shape that is one product, one fused
    multiply-add, one mask and one compare."""
    shape = tuple(int(n) for n in shape)
    if not shape:
        return bernoulli(seed, p, (1,), device).reshape(())
    s = _seed(seed)
    offs = offsets_of(seed) + (0,) * len(shape)
    h = _hash32((s & _M32) ^ _hash32(s >> 32))
    device = torch.device(device)
    k = len(shape)

    def coord(axis):
        view = [1] * k
        view[axis] = shape[axis]
        return _coords(shape[axis], offs[axis], device).view(view)

    row = torch.full((1,) * k, h, dtype=torch.int64, device=device)
    for axis in range(k - 1):
        row = _hash32(row ^ coord(axis))
    col = _hash32(coord(k - 1) ^ h)
    draw = torch.mul((row & _M30) | 1, col)
    draw.addcmul_(((row * _KEY2_ROW) & _M30) | 1, (col * _KEY2_COL) & _M32)
    threshold = min(int(round(p * 4294967296.0)), 1 << 32)
    return draw.bitwise_and_(_M40) < (threshold << 8)


def dropout(x: torch.Tensor, rate: float, seed) -> torch.Tensor:
    """x * keep / (1 - rate) with keep ~ Bernoulli(1 - rate) (JAX
    transformer.py:165-169); `x` itself where the rate is 0 or there is
    no stream. `seed`'s offsets place `x` in the global tensor."""
    if seed is None or rate == 0.0:
        return x
    keep = bernoulli(seed, 1.0 - rate, x.shape, x.device)
    return x * keep / (1.0 - rate)
