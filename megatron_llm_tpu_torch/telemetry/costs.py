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

- FLOPs: `torch.utils.flop_counter.FlopCounterMode` over the run (its
  formulas: matmuls, convolutions, attention library calls);
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

These counts differ from XLA's by definition: XLA counts every fused
elementwise operation and its own HBM traffic after fusion; here FLOPs
are the products and attention only, and bytes are unfused op by op.

The hot loop only ever calls `record()` and
`CostRecord.modeled_seconds`: a dict lookup and host arithmetic.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

__all__ = ["CostRecord", "CostRegistry", "note_launch"]


def _key_str(key: Any) -> str:
    return repr(key)


# the open capture of this thread: [flops, bytes, launches] the kernel
# wrappers add to (`note_launch`)
_tally = threading.local()


def note_launch(flops: float, nbytes: float) -> None:
    """A kernel wrapper's own count for one launch of its kernel. A
    no-op unless a capture is open on this thread."""
    t = getattr(_tally, "open", None)
    if t is not None:
        t[0] += flops
        t[1] += nbytes
        t[2] += 1


def _byte_mode():
    """A dispatch mode adding, for every aten op, the bytes of the
    distinct tensors it reads and writes (built on first use: the
    dispatch-mode machinery is torch's, imported only when counting)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class _Bytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.__name__
            if getattr(func, "is_view", False) or "empty" in name:
                return out
            seen = set()
            for x in tree_leaves((args, kwargs, out)):
                if isinstance(x, torch.Tensor) and id(x) not in seen:
                    seen.add(id(x))
                    self.nbytes += x.numel() * x.element_size()
            return out

    return _Bytes()


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
    """Cost capture keyed by (entry point, specialization). The JAX
    registry hooks its contract registry's mint listener; the port has
    none (ROADMAP.md A7), so its engine notes each mint (`note_mint`)
    and counts the first run itself (`capture`)."""

    def __init__(self, chip=None):
        self.chip = chip
        self._lock = threading.Lock()
        self._records: Dict[tuple, CostRecord] = {}
        self._pending: Dict[tuple, float] = {}
        self.captures = 0
        self.capture_errors = 0

    def note_mint(self, name: str, key: Any) -> None:
        with self._lock:
            self._pending.setdefault((name, _key_str(key)), time.time())

    # -- capture (once per entry point and key, never per round) -----------

    def has(self, name: str, key: Any) -> bool:
        return (name, _key_str(key)) in self._records

    def capture(self, name: str, key: Any, run: Callable[[], Any],
                arg_bytes: Optional[int] = None):
        """Run `run()` once under the counting modes and store its
        record; returns what `run()` returned. A failure of the counting
        itself is swallowed into `capture_errors` (the run's own errors
        propagate: it is real work)."""
        try:
            from torch.utils.flop_counter import FlopCounterMode

            flop_mode = FlopCounterMode(display=False)
            byte_mode = _byte_mode()
        except Exception:  # noqa: BLE001: counting must never block a mint
            with self._lock:
                self.capture_errors += 1
            return run()
        tally = [0.0, 0.0, 0]
        prev = getattr(_tally, "open", None)
        _tally.open = tally
        try:
            with flop_mode, byte_mode:
                out = run()
        finally:
            _tally.open = prev
        rec = CostRecord(contract=name, key=_key_str(key),
                         flops=float(flop_mode.get_total_flops()) + tally[0],
                         bytes_accessed=float(byte_mode.nbytes) + tally[1],
                         arg_bytes=arg_bytes, launches=tally[2])
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
