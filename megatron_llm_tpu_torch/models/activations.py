"""GLU activations and plain activations (port of models/activations.py).

Each GLU gates an up-projection: act(gate) * up. Each activation runs
under the "mlp_act" save point (JAX :16-26): elementwise work that no
recompute policy keeps, recomputed from the saved "mlp_pre_act".
"""

from __future__ import annotations

import functools

import torch.nn.functional as F

from megatron_llm_tpu_torch.models.remat import tag


def _named(fn):
    @functools.wraps(fn)
    def act(*args):
        with tag("mlp_act"):
            return fn(*args)
    return act


@_named
def liglu(gate, up):
    return gate * up


@_named
def geglu(gate, up):
    return F.gelu(gate) * up


@_named
def reglu(gate, up):
    return F.relu(gate) * up


@_named
def swiglu(gate, up):
    return F.silu(gate) * up


GLU_ACTIVATIONS = {
    "liglu": liglu,
    "geglu": geglu,
    "reglu": reglu,
    "swiglu": swiglu,
}

ACTIVATIONS = {
    "gelu": _named(F.gelu),
    "gelu_tanh": _named(functools.partial(F.gelu, approximate="tanh")),
    "relu": _named(F.relu),
    "silu": _named(F.silu),
}
