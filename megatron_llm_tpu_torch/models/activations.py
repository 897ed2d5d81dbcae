"""GLU activations and plain activations (port of models/activations.py).

Each GLU gates an up-projection: act(gate) * up.
"""

from __future__ import annotations

import torch.nn.functional as F


def liglu(gate, up):
    return gate * up


def geglu(gate, up):
    return F.gelu(gate) * up


def reglu(gate, up):
    return F.relu(gate) * up


def swiglu(gate, up):
    return F.silu(gate) * up


GLU_ACTIVATIONS = {
    "liglu": liglu,
    "geglu": geglu,
    "reglu": reglu,
    "swiglu": swiglu,
}

ACTIVATIONS = {
    "gelu": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}
