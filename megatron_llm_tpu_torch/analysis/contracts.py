"""Compile-contract registry (port of analysis/contracts.py): declared
budgets for every entry point that mints a specialised executable.

In the port an "executable" is what the JAX package's jit would mint
once per static key: a CUDA graph captured for one engine round kind
and bucket (`inference/graph_capture.CapturedFn`), the whole-batch
decode step of one call, one train step built per microbatch count,
one eval step flavour, one pipelined scorer or ring. Each mint site
records a VARIANT under the JAX contract's name, owner and budget:

- `record_variant(name, key, owner, budget)` counts one minted
  executable under `owner` (an engine, a trainer, a model; None is the
  module-global bucket); past min(budget, the contract's
  `max_variants`) it raises `ContractViolation` AT MINT TIME, before the
  capture runs;
- `release_variant` un-counts an executable that is freed;
- owners are held by weakref finalizers: a collected engine's bucket
  goes with it, so a recycled id() never inherits its count;
- call-site budgets only tighten the declared one;
- mint listeners (`add_mint_listener`) see every new variant:
  `telemetry/costs.CostRegistry.attach` builds its pending inventory
  from them.

`COLLECTIVE_OPS` keeps the JAX names (XLA's opcode families).
`TORCH_COLLECTIVES` maps each `torch.distributed` call the port makes
to one of them; `analysis/audit.py` records the calls a reference
target issues and checks them against the contract's inventory for the
mesh tag.

Imports neither torch nor JAX: every engine, trainer and test imports
this module.
"""

from __future__ import annotations

import functools
import threading
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, Mapping, Optional

__all__ = [
    "COLLECTIVE_OPS",
    "TORCH_COLLECTIVES",
    "CompileContract",
    "ContractViolation",
    "compile_contract",
    "get_contract",
    "all_contracts",
    "record_variant",
    "release_variant",
    "register_contract",
    "variants",
    "variant_count",
    "total_live_variants",
    "get_builder",
    "add_mint_listener",
    "remove_mint_listener",
]


class ContractViolation(AssertionError):
    """An entry point broke its declared compile contract (variant
    budget exceeded at mint time, or an audit check failed). Deliberately
    an AssertionError: test suites that pin executable counts fail the
    same way they always did, through the one shared counter."""


# Collective-inventory keys: the JAX package's names (the optimized-HLO
# opcode families); a contract declares, per mesh-shape tag, EXACTLY the
# set a reference run may issue.
COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
    "collective-broadcast",
)

# Each torch.distributed call of the port -> its JAX collective name.
TORCH_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_single": "all-gather",
    "all_gather_object": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "send": "collective-permute",
    "recv": "collective-permute",
    "isend": "collective-permute",
    "irecv": "collective-permute",
    "batch_isend_irecv": "collective-permute",
    "broadcast": "collective-broadcast",
    "broadcast_object_list": "collective-broadcast",
    "all_to_all": "all-to-all",
    "all_to_all_single": "all-to-all",
}


@dataclass(frozen=True)
class CompileContract:
    """The declaration one entry point audits against.

    - `max_variants`: absolute ceiling on live executables this entry
      point may hold per owner (None = uncounted). Call sites may pass a
      TIGHTER config-derived budget at record time; this value is the
      registry-wide backstop and what the audit's bucket math checks.
    - `collectives`: mesh-shape tag -> frozenset of collective names
      (COLLECTIVE_OPS) the reference run may issue ("single" tags the
      no-mesh case, where the set is empty). None = not audited for
      collectives.
    - `tmp_bytes_budget`: the JAX declaration's compiled temp-memory
      ceiling, kept for the record: torch has no compiled artifact on
      the CPU, so the port checks it on the card only, through the
      engine's graph-pool bytes (`CostRegistry.note_temp`).
    - `allow_host_callbacks` / `allow_f64`: host syncs inside the target
      and float64 tensors, both audited to "absent" unless allowed.
    """

    name: str
    max_variants: Optional[int] = None
    collectives: Optional[Mapping[str, FrozenSet[str]]] = None
    tmp_bytes_budget: Optional[int] = None
    allow_host_callbacks: bool = False
    allow_f64: bool = False
    notes: str = ""

    def __post_init__(self):
        if self.collectives is not None:
            for tag, ops in self.collectives.items():
                bad = set(ops) - set(COLLECTIVE_OPS)
                if bad:
                    raise ValueError(
                        f"contract {self.name!r}: unknown collective "
                        f"opcodes {sorted(bad)} for mesh {tag!r} "
                        f"(known: {COLLECTIVE_OPS})")


_LOCK = threading.RLock()
_REGISTRY: Dict[str, CompileContract] = {}
_BUILDERS: Dict[str, Callable] = {}

# Variant store: name -> owner-token -> {key: None} (an insertion-ordered
# set; dict for O(1) discard). Owner tokens are id(owner) with a weakref
# finalizer so a garbage-collected engine's bucket — and its recycled
# id() — can never pollute a later owner's count. None owner = the
# module-global bucket (module-scope executable caches).
_GLOBAL = "<global>"
_VARIANTS: Dict[str, Dict[Any, Dict[Any, None]]] = {}

# Mint listeners: callbacks fired once per NEW variant
# record_variant accepts — the hook telemetry/costs.CostRegistry rides
# so the compiled-cost inventory mirrors the executable inventory
# exactly (mint-time only; nothing fires on cache hits or releases).
# Fired OUTSIDE the registry lock: a listener may take its own locks.
_MINT_LISTENERS: list = []


def add_mint_listener(cb) -> None:
    """Register cb(name, key, owner), called once per newly recorded
    variant. Listeners must be cheap host bookkeeping (they run at the
    mint site, which may sit inside a serving round's lazy trace) and
    must never raise — exceptions propagate to the minting caller."""
    with _LOCK:
        if cb not in _MINT_LISTENERS:
            _MINT_LISTENERS.append(cb)


def remove_mint_listener(cb) -> None:
    with _LOCK:
        try:
            _MINT_LISTENERS.remove(cb)
        except ValueError:
            pass


def register_contract(contract: CompileContract,
                      builder: Optional[Callable] = None) -> CompileContract:
    """Install (or replace — module reloads in tests) a contract."""
    with _LOCK:
        _REGISTRY[contract.name] = contract
        if builder is not None:
            _BUILDERS[contract.name] = builder
        _VARIANTS.setdefault(contract.name, {})
    return contract


def get_contract(name: str) -> CompileContract:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no compile contract registered under {name!r} "
            f"(registered: {sorted(_REGISTRY)})") from None


def all_contracts() -> Dict[str, CompileContract]:
    with _LOCK:
        return dict(_REGISTRY)


def get_builder(name: str) -> Callable:
    """The undecorated builder a contract was registered from (the
    audit constructs entry points through this)."""
    get_contract(name)
    try:
        return _BUILDERS[name]
    except KeyError:
        raise KeyError(
            f"contract {name!r} has no builder (registered via "
            f"register_contract without one — audit it through an "
            f"explicit target spec instead)") from None


def _owner_token(owner: Any):
    return _GLOBAL if owner is None else id(owner)


def _drop_owner(name: str, token) -> None:
    with _LOCK:
        _VARIANTS.get(name, {}).pop(token, None)


def record_variant(name: str, key: Any, owner: Any = None,
                   budget: Optional[int] = None) -> bool:
    """Count one minted executable for `name` under `owner`. Returns
    True when the key is new. Raises ContractViolation when the live
    count would exceed min(budget, contract.max_variants)."""
    contract = get_contract(name)
    limits = [b for b in (budget, contract.max_variants) if b is not None]
    limit = min(limits) if limits else None
    listeners = ()
    with _LOCK:
        token = _owner_token(owner)
        per_name = _VARIANTS.setdefault(name, {})
        bucket = per_name.get(token)
        if bucket is None:
            bucket = per_name[token] = {}
            if owner is not None:
                try:
                    # drop the bucket when the owner dies: id() values
                    # are recycled, and a stale bucket under a recycled
                    # id would hand a brand-new engine another engine's
                    # variant count. ONE finalizer per bucket — not per
                    # registry call — or a long-lived engine's LRU churn
                    # would pile up duplicate finalizers for its lifetime
                    weakref.finalize(owner, _drop_owner, name, token)
                except TypeError:
                    pass  # un-weakrefable owners keep their bucket
        if key in bucket:
            return False
        if limit is not None and len(bucket) + 1 > limit:
            raise ContractViolation(
                f"compile contract {name!r}: minting variant {key!r} "
                f"would exceed the declared budget of {limit} "
                f"executables (live: {sorted(map(repr, bucket))}). "
                f"Either the bucketing that bounds this entry point "
                f"regressed (a retrace storm), or the budget declaration "
                f"must be updated WITH justification "
                f"(megatron_llm_tpu_torch/analysis/contracts.py)")
        bucket[key] = None
        listeners = tuple(_MINT_LISTENERS)
    for cb in listeners:  # outside the lock, new mints only
        cb(name, key, owner)
    return True


def release_variant(name: str, key: Any, owner: Any = None) -> bool:
    """Un-count an EVICTED executable (LRU caches): the budget bounds
    live executables, which is what the eviction exists to do."""
    get_contract(name)
    with _LOCK:
        bucket = _VARIANTS.get(name, {}).get(_owner_token(owner))
        if bucket is None or key not in bucket:
            return False
        del bucket[key]
        return True


def variants(name: str, owner: Any = None) -> FrozenSet:
    """The live variant-key set for (entry point, owner) — the ONE
    counting mechanism the per-suite executable guards read."""
    get_contract(name)
    with _LOCK:
        bucket = _VARIANTS.get(name, {}).get(_owner_token(owner), {})
        return frozenset(bucket)


def variant_count(name: str, owner: Any = None) -> int:
    return len(variants(name, owner))


def total_live_variants(name: str) -> int:
    """Live executables for `name` summed across ALL owner buckets:
    what the audit report publishes (per-owner counts would read 0 for
    engine-scoped contracts when the reader holds no engine)."""
    get_contract(name)
    with _LOCK:
        return sum(len(b) for b in _VARIANTS.get(name, {}).values())


def _auto_key(args, kwargs):
    """Fallback variant key when a call site passes none: the hashable
    primitive args (the statics — ints/bools/strs — that split the
    executables), in position order. Model objects / configs are
    deliberately excluded: they select the OWNER, not the variant."""
    prim = (int, bool, float, str, bytes, type(None), tuple, frozenset)
    key = [a for a in args if isinstance(a, prim)]
    key += [v for _, v in sorted(kwargs.items()) if isinstance(v, prim)]
    return tuple(key)


def compile_contract(name: str, *, max_variants: Optional[int] = None,
                     collectives: Optional[Mapping[str, FrozenSet[str]]]
                     = None,
                     tmp_bytes_budget: Optional[int] = None,
                     allow_host_callbacks: bool = False,
                     allow_f64: bool = False, notes: str = ""):
    """Decorator for an entry-point BUILDER: registers the contract and
    makes every builder invocation record a variant.

    The wrapped builder accepts three extra keyword-only knobs, all
    popped before the real builder runs:
    - `contract_key`: the variant identity (defaults to the hashable
      primitive args — the statics);
    - `contract_owner`: whose budget the mint counts against (an engine
      instance, a trainer; None = module-global);
    - `contract_budget`: a config-derived budget tighter than the
      declared `max_variants` (the engine's pow2 bucket math).
    """

    def deco(builder):
        contract = CompileContract(
            name=name, max_variants=max_variants, collectives=collectives,
            tmp_bytes_budget=tmp_bytes_budget,
            allow_host_callbacks=allow_host_callbacks, allow_f64=allow_f64,
            notes=notes)
        register_contract(contract, builder)

        @functools.wraps(builder)
        def wrapped(*args, contract_key=None, contract_owner=None,
                    contract_budget=None, **kwargs):
            fn = builder(*args, **kwargs)
            record_variant(
                name,
                contract_key if contract_key is not None
                else _auto_key(args, kwargs),
                owner=contract_owner, budget=contract_budget)
            return fn

        wrapped.contract = contract
        wrapped.__contract_builder__ = builder
        return wrapped

    return deco
