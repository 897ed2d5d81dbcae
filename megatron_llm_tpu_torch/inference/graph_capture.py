"""Round capture: one serving round as a CUDA graph, replayed on static
buffers (the port's form of `jax.jit`; the JAX package has no module of
its own for it).

The JAX engine compiles each round into one program per bucket (its
`_step_fn` / `_mixed_fn` / `_spec_fn` mint caches and `warmup()`), and
the whole-batch decode is one `lax.while_loop`. Run eagerly, the same
rounds spend most of their wall time in the host's launches (PERF.md §5).
`CapturedFn` captures a round's function once into a CUDA graph and
replays it:

- every input the host changes between rounds is a static device buffer,
  filled by `copy_` from a pinned host buffer before each replay (a copy
  from pinned memory does not wait for the card); every other operand
  (weights, page pools, a carried logits buffer the function updates in
  place) is bound into the function and captured by address;
- the function's outputs are static too: each replay overwrites them, so
  the caller reads what it needs before the next replay (and that read,
  the round's one wait for the card, also frees the pinned buffers for
  the next call's host arrays);
- before the capture the function runs eagerly on the capture stream
  (Triton compiles, a CUDA kernel raises its shared-memory limit, cuBLAS
  makes its workspace, the split kernels' arrival counters are sized:
  nothing of that may happen inside a capture), then it is captured in
  `capture_error_mode="thread_local"` (the HTTP threads keep running)
  into the memory pool its owner passes: one pool for all the graphs of
  an engine, whose rounds never run at the same time;
- launch counts: the kernels' counters are Python ints that move when a
  wrapper launches. A capture launches nothing, so the counts a capture
  moved are put back and added again at every replay;
- a generator given to the runner (a sampled whole-batch decode) is
  registered with the graph, so each replay draws from its current state
  as an eager call would.

On a CPU device the function runs eagerly on the same static buffers at
every call, so the CPU tests run the buffer logic the card replays. A
capture that fails raises: nothing falls back to the eager function.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from megatron_llm_tpu_torch.ops import decode_attention as _dec
from megatron_llm_tpu_torch.ops import flash_attention as _fa
from megatron_llm_tpu_torch.ops import prefill_attention as _pa
from megatron_llm_tpu_torch.ops import rmsnorm as _rms

# eager runs on the capture stream before the capture
WARMUP_RUNS = 2


def _counted():
    return (_dec.decode_attention, _pa.ragged_paged_attention,
            _rms.fused_rms_norm, _rms.rms_norm_bwd, _fa.flash_fwd,
            _fa.flash_bwd_dq, _fa.flash_bwd_dkv)


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, K7's counts by variant and
    design and K1's by cache layout, as one flat dict."""
    out = {fn.__name__: fn.launches for fn in _counted()}
    for k, v in _pa.ragged_paged_attention.variant_launches.items():
        out["ragged_paged_attention:" + k] = v
    for k, v in _dec.decode_attention.launches_by_layout.items():
        out["decode_attention:" + k] = v
    return out


def add_launch_counts(delta: Dict[str, int]) -> None:
    """Add `delta` (a `launch_counts()` difference) to the counters."""
    for fn in _counted():
        fn.launches += delta.get(fn.__name__, 0)
    for fn, counts in (
            (_pa.ragged_paged_attention,
             _pa.ragged_paged_attention.variant_launches),
            (_dec.decode_attention, _dec.decode_attention.launches_by_layout)):
        for k in counts:
            counts[k] += delta.get(f"{fn.__name__}:{k}", 0)


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


class CapturedFn:
    """`fn(**inputs)` captured once and replayed (see the module note).

    `inputs` maps each per-call input's name to a host array: its shape
    and dtype make the static device buffer, its values are the ones the
    warm-up runs and the capture see (the caller passes values that
    change nothing it keeps: the engine's idle rounds). `capture=False`,
    or a CPU `device`, runs `fn` eagerly on the static buffers at every
    call instead. `generators` are registered with the graph."""

    def __init__(self, fn: Callable, inputs: Dict[str, np.ndarray], *,
                 device, pool=None, stream: Optional[torch.cuda.Stream] = None,
                 capture: bool = True,
                 generators: Sequence[torch.Generator] = ()):
        self.fn = fn
        self.device = torch.device(device)
        self.captured = capture and self.device.type == "cuda"
        self.inputs = {k: torch.from_numpy(np.array(v)).to(self.device)
                       for k, v in inputs.items()}
        self._staging = {}
        if self.captured:
            self._staging = {k: torch.empty(v.shape, dtype=v.dtype,
                                            pin_memory=True)
                             for k, v in self.inputs.items()}
        self.graph = None
        self.outputs = None
        self.launch_delta: Dict[str, int] = {}
        self.capture_s = 0.0
        if self.captured:
            self._capture(pool, stream, generators)

    def _capture(self, pool, stream, generators):
        t0 = time.perf_counter()
        stream = stream or torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_RUNS):
                self.fn(**self.inputs)
        current.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        before = launch_counts()
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.outputs = self.fn(**self.inputs)
        after = launch_counts()
        # the capture launched nothing: its counts go back, and every
        # replay adds them
        self.launch_delta = _diff(after, before)
        add_launch_counts({k: -v for k, v in self.launch_delta.items()})
        self.graph = graph
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, **host):
        """Copy the given host arrays into their static buffers, then
        replay (or, uncaptured, call `fn`). Returns the outputs, which
        the next call overwrites."""
        for k, v in host.items():
            buf = self.inputs[k]
            if self.captured:
                stage = self._staging[k]
                stage.numpy()[...] = v
                buf.copy_(stage, non_blocking=True)
            else:
                buf.copy_(torch.from_numpy(np.asarray(v)))
        if not self.captured:
            return self.fn(**self.inputs)
        self.graph.replay()
        add_launch_counts(self.launch_delta)
        return self.outputs
