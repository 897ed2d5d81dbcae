"""Where the overlap schedulers meet the model's forward and backward
(`--overlap_grad_reduce`, `--overlap_param_gather`; optimizer/zero1.py).

The port's model is functions over a parameter tree, with no modules to
hang hooks on, so the two schedulers reach it through two per-thread
slots that the layer stack and the embedding consult:

- `grad_hooks(fn)`: inside the block, `models/transformer.py`'s
  `unstack_layers` passes every per-layer view of every stacked leaf
  through a tap (`tap_layers`), an identity whose backward calls
  `fn(j, layer, grad)` as soon as that layer's gradient is complete,
  after any recompute of the layer: j is the leaf's index in the layers
  subtree's leaf order.
- `param_gate(gate)`: inside the block, the forward calls
  `gate.before_embedding()` before it reads the embedding and
  `gate.before_layer(i)` before layer i, so that a parameter
  all-gather in flight is waited for just before its leaves are read.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_TLS = threading.local()


class _Tap(torch.autograd.Function):
    """Identity; its backward reports the gradient that reached it."""

    @staticmethod
    def forward(ctx, x, fn, j, layer):
        ctx.fn, ctx.j, ctx.layer = fn, j, layer
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.fn(ctx.j, ctx.layer, grad)
        return grad, None, None, None


def tap_layers(parts: dict, fn) -> dict:
    """`parts` (leaf name -> tuple of per-layer views, nested) with each
    view tapped for `fn`; j counts the leaves in sorted-key order."""
    count = [0]

    def walk(tree):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            j = count[0]
            count[0] += 1
            out[k] = tuple(_Tap.apply(x, fn, j, i) if x.requires_grad else x
                           for i, x in enumerate(v))
        return out

    return walk(parts)


@contextlib.contextmanager
def grad_hooks(fn):
    prev = getattr(_TLS, "grad_hook", None)
    _TLS.grad_hook = fn
    try:
        yield
    finally:
        _TLS.grad_hook = prev


def current_grad_hook():
    return getattr(_TLS, "grad_hook", None)


@contextlib.contextmanager
def param_gate(gate):
    prev = getattr(_TLS, "gate", None)
    _TLS.gate = gate
    try:
        yield
    finally:
        _TLS.gate = prev


def before_embedding() -> None:
    gate = getattr(_TLS, "gate", None)
    if gate is not None:
        gate.before_embedding()


def before_layer(layer: int) -> None:
    gate = getattr(_TLS, "gate", None)
    if gate is not None:
        gate.before_layer(layer)
