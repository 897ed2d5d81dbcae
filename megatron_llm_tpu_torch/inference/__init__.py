"""Whole-batch generation, the continuous-batching engine, the replica
router and fleet: the JAX package's exports (the port's sampling step is
`generation.select_next_token`, where the JAX package exports
`sampling.sample`). Each name loads its module on first use, so that
importing one module of this package (the pipeline imports
`generation`) does not import them all."""

import importlib

_EXPORTS = {
    "beam_search_and_post_process": "api",
    "generate_and_post_process": "api",
    "beam_search": "generation",
    "generate_tokens": "generation",
    "score_tokens": "generation",
    "select_next_token": "generation",
    "DecodeEngine": "engine",
    "EngineRequest": "engine",
    "QueueFull": "engine",
    "PrefixCache": "prefix_cache",
    "EngineReplica": "router",
    "HTTPReplica": "router",
    "ReplicaRouter": "router",
    "ChaosFault": "chaos",
    "ChaosPolicy": "chaos",
    "FleetController": "fleet",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
