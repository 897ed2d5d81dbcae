"""Dropout with masks drawn from derived seeds (the port's form of the
JAX package's `jax.random` key stream for dropout).

The JAX package folds and splits one key down the model: the trainer's
base key `seed + 1` folded with the iteration (training/trainer.py
:991-997), with the microbatch (train_step.py:281), split between the
embedding and the stack (language_model.py), folded with the layer index
and split three ways inside a layer (transformer.py:176-180). Here a
stream is a 63-bit integer seed and `fold_in` / `split` mix it with the
same data, so every mask comes from a seed that is a pure function of
(base seed, iteration, microbatch, layer, site). A mask is drawn from a
fresh `torch.Generator` seeded with it, never from a generator that
advances: a recomputed layer (models/remat.py) draws the same masks
again, which torch's checkpoint, replaying only the global generators,
would not ensure. The bits are torch's, not jax.random's.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _mix(z: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit integers."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    """The stream `seed` folded with the integer `data`
    (jax.random.fold_in)."""
    return _mix(seed ^ _mix(int(data) & _MASK64)) >> 1


def split(seed: int, n: int = 2) -> tuple:
    """n streams derived from `seed` (jax.random.split), apart from any
    `fold_in(seed, i)`."""
    return tuple(_mix(_mix(seed) + 2 * i + 1) >> 1 for i in range(n))


def bernoulli(seed: int, p: float, shape, device) -> torch.Tensor:
    """A bool mask of `shape`, True with probability `p`, drawn from a
    generator seeded with `seed` (jax.random.bernoulli)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device) < p


def dropout(x: torch.Tensor, rate: float, seed) -> torch.Tensor:
    """x * keep / (1 - rate) with keep ~ Bernoulli(1 - rate) (JAX
    transformer.py:165-169); `x` itself where the rate is 0 or there is
    no stream."""
    if seed is None or rate == 0.0:
        return x
    keep = bernoulli(seed, 1.0 - rate, x.shape, x.device)
    return x * keep / (1.0 - rate)
