"""Device-cost registry: FLOPs, bytes and temp memory per engine entry
point, captured once per (entry point, specialization) (port of
telemetry/costs.py).

The JAX registry reads XLA's `cost_analysis()` and `memory_analysis()`
of each jitted program when it is minted. Torch has neither, so the
port counts the work of the first eager run of each round instead, at
the moments the JAX engine mints: the first warm-up run before a CUDA
graph captures a round (`graph_capture.CapturedFn`), the first eager
run of a new key (a CPU engine, an uncaptured round, the whole-prompt
prefill of a new bucket), and the page copy, export and import once at
construction. Per run:

- FLOPs: `torch.utils.flop_counter`'s formulas (matmuls,
  convolutions, attention library calls) for every aten op of the run,
  each op run as it was called (`_count_mode`), and the products that
  reach the count whole on inference tensors, which no autograd key
  decomposes (`matmul`, `linear`, `einsum`), and the port's flash
  forward op run plain on the CPU (`_whole_op_flops`);
- bytes: for every aten op of the run, the bytes of the distinct tensors
  it reads and writes (view and allocation ops move nothing and count
  nothing);
- kernels launched through ctypes or Triton (K1, K2, K7, ...) are seen
  by no dispatcher mode, so each wrapper in `ops/` reports its own FLOPs
  and bytes for a launch (`note_launch`), from its shapes (the most its
  launch can read and compute: the host never reads the lengths on the
  card); the registry adds them to the run's totals. A wrapper running
  its plain version on a CPU tensor reports nothing: its ops are counted
  like any other;
- temp bytes: the engine's CUDA graph pool's reserved bytes after the
  capture (the pool is shared by all of an engine's rounds), None on
  the CPU; arg bytes: the bytes the run binds (weights, pools, inputs).

The trainer captures `train.step` (and `train.pipeline_step` at pp > 1),
keyed by the microbatch count, on the first real step of each count,
while that step runs: no extra step is taken, so the parameters and the
optimizer move exactly as with the registry off. A training step's
backward runs on autograd's device threads, so that capture opens its
tally for every thread (`all_threads=True`): the dispatch modes follow
autograd there, and K4-K6's wrappers report their launches from there.

These counts differ from XLA's by definition: XLA counts every fused
elementwise operation and its own HBM traffic after fusion; here FLOPs
are the products and attention only, and bytes are unfused op by op.

The hot loop only ever calls `record()` and
`CostRecord.modeled_seconds`: a dict lookup and host arithmetic.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

__all__ = ["CostRecord", "CostRegistry", "Counting", "note_launch"]


def _key_str(key: Any) -> str:
    return repr(key)


# the open capture of this thread: [flops, bytes, launches] the kernel
# wrappers add to (`note_launch`)
_tally = threading.local()
# the open capture of every thread without one of its own (a capture with
# all_threads=True: the trainer's step, whose backward runs on autograd's
# threads); a list so that it is rebound, never mutated, across threads
_shared = [None]


def note_launch(flops: float, nbytes: float) -> None:
    """A kernel wrapper's own count for one launch of its kernel. A
    no-op unless a capture is open on this thread (or one for all
    threads)."""
    t = getattr(_tally, "open", None)
    if t is None:
        t = _shared[0]
    if t is not None:
        t[0] += flops
        t[1] += nbytes
        t[2] += 1


def _count_mode():
    """A dispatch mode counting, for every aten op it sees, its FLOPs by
    `torch.utils.flop_counter`'s formulas (products, convolutions,
    attention library calls) and the bytes of the distinct tensors it
    reads and writes (view and allocation ops move nothing and count
    nothing). It runs each op as it was called: torch's
    `FlopCounterMode` decomposes ops its table lacks into other ops,
    which can change a run's rounding, so it is not used. Built on first
    use: the dispatch-mode machinery is torch's, imported only when
    counting."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    class _Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            leaves = tree_leaves((args, kwargs, out))
            if func.namespace == "megatron_llm_tpu_torch" and any(
                    isinstance(x, torch.Tensor) and x.is_cuda
                    for x in leaves):
                # the port's own op (the flash forward) launched its
                # kernel, whose wrapper reported it (`note_launch`)
                return out
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            else:
                self.flops += _whole_op_flops(func, args, out)
            name = func.__name__
            if getattr(func, "is_view", False) or "empty" in name:
                return out
            seen = set()
            for x in leaves:
                if isinstance(x, torch.Tensor) and id(x) not in seen:
                    seen.add(id(x))
                    self.nbytes += x.numel() * x.element_size()
            return out

    return _Count()


def _whole_op_flops(func, args, out) -> float:
    """The FLOPs of a product that reaches the count whole, 2 a
    multiply-add: `matmul`, `linear` and `einsum` on inference tensors
    (no autograd key decomposes them into `mm`, `bmm` and `addmm`, which
    flop_counter's formulas count), and the port's flash forward op on
    the CPU, its plain version (S and PV, half of them under the causal
    mask; on the card its wrapper reports its launch). 0 for any other
    op."""
    import torch

    name = func._overloadpacket.__name__
    if name == "flash_fwd" and func.namespace == "megatron_llm_tpu_torch":
        # (b, s, g, qpk, d) rows against t positions
        b, s, g, qpk, d = args[0].shape
        causal = args[3] if len(args) > 3 else True
        return 4.0 * b * s * g * qpk * args[1].shape[1] * d * (
            0.5 if causal else 1.0)
    if func.namespace != "aten":
        return 0.0
    if name in ("matmul", "linear") and isinstance(out, torch.Tensor):
        return 2.0 * out.numel() * args[0].shape[-1]
    if name == "einsum":
        sizes = {}
        for term, x in zip(args[0].replace(" ", "").split("->")[0]
                           .split(","), args[1]):
            sizes.update(zip(term, x.shape))
        total = 2.0
        for n in sizes.values():
            total *= n
        return total
    return 0.0


class Counting:
    """The FLOPs and bytes of everything run inside the block
    (`_count_mode`), plus the launches the kernel wrappers report
    (`note_launch`) on this thread, or with `all_threads` on every
    thread without an open count of its own. After the block: `flops`,
    `nbytes` and `launches`. Building one can fail where torch's
    dispatch-mode machinery is missing; a caller that must not fail
    builds it first."""

    def __init__(self, all_threads: bool = False):
        self._mode = _count_mode()
        self._all_threads = all_threads
        self._tally = [0.0, 0.0, 0]
        self._prev = None
        self.flops = self.nbytes = 0.0
        self.launches = 0

    def __enter__(self) -> "Counting":
        self._prev = (getattr(_tally, "open", None), _shared[0])
        _tally.open = self._tally
        if self._all_threads:
            _shared[0] = self._tally
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._mode.__exit__(*exc)
        finally:
            _tally.open = self._prev[0]
            if self._all_threads:
                _shared[0] = self._prev[1]
        self.flops = float(self._mode.flops) + self._tally[0]
        self.nbytes = float(self._mode.nbytes) + self._tally[1]
        self.launches = self._tally[2]
        return False


@dataclass
class CostRecord:
    """The captured device-cost facts of one entry point."""

    contract: str
    key: str
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    temp_bytes: Optional[int] = None
    arg_bytes: Optional[int] = None
    source: str = "counted"  # the port counts one eager run
    captured_unix: float = field(default_factory=time.time)
    launches: int = 0  # kernel launches that reported their own counts

    def modeled_seconds(self, chip, n_chips: int = 1,
                        dtype: str = "bf16") -> Optional[float]:
        """Roofline device time for one execution on `chip`
        (telemetry/chipspec.ChipSpec): the larger of the compute leg
        (flops / peak) and the memory leg (bytes / HBM rate), across
        `n_chips` cards. None when the record or chip cannot support
        the estimate."""
        if chip is None:
            return None
        legs = []
        if self.flops:
            legs.append(self.flops / (chip.peak_flops_for(dtype)
                                      * max(n_chips, 1)))
        if self.bytes_accessed:
            legs.append(self.bytes_accessed / (chip.hbm_bytes_s
                                               * max(n_chips, 1)))
        return max(legs) if legs else None

    def to_dict(self) -> dict:
        return {
            "contract": self.contract, "key": self.key,
            "flops": self.flops, "bytes_accessed": self.bytes_accessed,
            "temp_bytes": self.temp_bytes, "arg_bytes": self.arg_bytes,
            "source": self.source,
        }


class CostRegistry:
    """Cost capture keyed by (entry point, specialization). `attach()`
    hooks the contract registry's mint listener (analysis/contracts.py),
    as the JAX registry does: every new variant `record_variant` accepts
    (for `owner`'s mints only, when one is given) lands in the pending
    inventory until its first run is counted (`capture`)."""

    def __init__(self, chip=None, owner=None):
        self.chip = chip
        self._owner_ref = weakref.ref(owner) if owner is not None else None
        self._lock = threading.Lock()
        self._records: Dict[tuple, CostRecord] = {}
        self._pending: Dict[tuple, float] = {}
        self._listener = None
        self.captures = 0
        self.capture_errors = 0

    def attach(self) -> "CostRegistry":
        """Install the mint listener (idempotent). The listener holds this
        registry by weakref only, and removes itself once the registry
        is gone."""
        if self._listener is not None:
            return self
        from megatron_llm_tpu_torch.analysis import contracts

        ref, owner_ref = weakref.ref(self), self._owner_ref

        def on_mint(name, key, owner):
            reg = ref()
            if reg is None:
                contracts.remove_mint_listener(on_mint)
                return
            if owner_ref is not None and owner is not owner_ref():
                return
            reg.note_mint(name, key)

        self._listener = on_mint
        contracts.add_mint_listener(on_mint)
        return self

    def detach(self) -> None:
        if self._listener is not None:
            from megatron_llm_tpu_torch.analysis import contracts

            contracts.remove_mint_listener(self._listener)
            self._listener = None

    def note_mint(self, name: str, key: Any) -> None:
        with self._lock:
            self._pending.setdefault((name, _key_str(key)), time.time())

    # -- capture (once per entry point and key, never per round) -----------

    def has(self, name: str, key: Any) -> bool:
        return (name, _key_str(key)) in self._records

    def capture(self, name: str, key: Any, run: Callable[[], Any],
                arg_bytes: Optional[int] = None, all_threads: bool = False):
        """Run `run()` once under the counting modes and store its
        record; returns what `run()` returned. A failure of the counting
        itself is swallowed into `capture_errors` (the run's own errors
        propagate: it is real work). `all_threads`: kernel launches on
        other threads count too (module doc)."""
        try:
            count = Counting(all_threads)
        except Exception:  # noqa: BLE001: counting must never block a mint
            with self._lock:
                self.capture_errors += 1
            return run()
        with count:
            out = run()
        rec = CostRecord(contract=name, key=_key_str(key),
                         flops=count.flops, bytes_accessed=count.nbytes,
                         arg_bytes=arg_bytes, launches=count.launches)
        self._store(rec)
        return out

    def note_temp(self, name: str, key: Any, temp_bytes) -> None:
        """The temp bytes of a captured entry point (the graph pool's
        reserved bytes after its capture)."""
        with self._lock:
            rec = self._records.get((name, _key_str(key)))
            if rec is not None and temp_bytes is not None:
                rec.temp_bytes = int(temp_bytes)
                rec.source = "captured"

    def _store(self, rec: CostRecord) -> CostRecord:
        with self._lock:
            self._records[(rec.contract, rec.key)] = rec
            self._pending.pop((rec.contract, rec.key), None)
            self.captures += 1
        return rec

    # -- hot-loop reads: host lookups only ----------------------------------

    def record(self, name: str, key: Any = None) -> Optional[CostRecord]:
        """The record for (entry point, specialization); with key=None,
        any record under the entry point. A dict lookup: the engine's
        per-round dispatch accounting calls this."""
        if key is not None:
            return self._records.get((name, _key_str(key)))
        for (n, _k), rec in self._records.items():
            if n == name:
                return rec
        return None

    # -- export --------------------------------------------------------------

    def rows(self) -> List[dict]:
        with self._lock:
            recs = sorted(self._records.values(),
                          key=lambda r: (r.contract, r.key))
            pending = sorted(k for k in self._pending)
        out = [r.to_dict() for r in recs]
        out.extend({"contract": n, "key": k, "pending": True}
                   for n, k in pending)
        return out

    def snapshot(self) -> dict:
        """Flight-recorder / /metrics attachment: the whole table plus
        capture health."""
        return {
            "chip": self.chip.label() if self.chip else None,
            "captures": self.captures,
            "capture_errors": self.capture_errors,
            "records": self.rows(),
        }

    def prometheus_lines(self, prefix: str = "") -> List[str]:
        """Labeled Prometheus gauges for the /metrics text exposition:
        one sample per (entry point, specialization) per fact."""
        metrics = (("cost_flops", "flops"),
                   ("cost_bytes_accessed", "bytes_accessed"),
                   ("cost_temp_bytes", "temp_bytes"),
                   ("cost_arg_bytes", "arg_bytes"))
        with self._lock:
            recs = sorted(self._records.values(),
                          key=lambda r: (r.contract, r.key))
        lines: List[str] = []
        for mname, attr in metrics:
            samples = []
            for r in recs:
                v = getattr(r, attr)
                if v is None:
                    continue
                key = r.key.replace("\\", "\\\\").replace('"', '\\"')
                samples.append(
                    f'{prefix}{mname}{{contract="{r.contract}",'
                    f'key="{key}"}} {v:g}')
            if samples:
                lines.append(f"# TYPE {prefix}{mname} gauge")
                lines.extend(samples)
        return lines
