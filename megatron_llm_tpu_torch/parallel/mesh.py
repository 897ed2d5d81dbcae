"""Process groups for tensor, sequence, data, pipeline and context
parallelism (port of parallel/mesh.py).

The JAX package builds one device mesh with named axes (data, stage,
context, model) and lets GSPMD insert the collectives. The port runs one
process per rank, as the reference does, and each collective is issued
by hand (parallel/mappings.py, optimizer/zero1.py): here are the
`torch.distributed` groups it issues them on, built in `build_mesh`'s
rank order, a (dp, pp, cp, tp) grid with tp fastest (JAX :164-188):

- a tp group per (dp, pp, cp) coordinate: the tensor- and
  sequence-parallel collectives and the vocab-parallel cross entropy;
- a dp group per (pp, cp, tp) coordinate: the gradient reduction and
  ZeRO-1's reduce-scatter and all-gather;
- a pp group per (dp, cp, tp) coordinate: the stages of one pipeline,
  for the stage-replicated leaves' gradient sum, the last stage's loss
  and the serving ring's broadcasts (parallel/pipeline.py);
- a cp group per (dp, pp, tp) coordinate: the ranks that hold one
  sequence in contiguous shards, for ring attention's K/V rotation
  (parallel/ring_attention.py), the loss's sums and the gradient sum;
- the whole world, for the gradient norm and the fp16 overflow flag.

The pipeline's boundaries travel point to point (`send_boundary`,
`recv_boundary`) between the same (dp, cp, tp) coordinate of adjacent
stages, in the compute dtype. The ring's blocks travel point to point
too (`ring_shift`): every cp rank sends to the next and receives from
the previous in one batch, so the ring cannot deadlock.

`initialize_parallel(..., backend=None)` takes NCCL for CUDA and gloo
for the CPU. Gloo moves CUDA tensors through host memory: with gloo and
a CUDA device the context is `staged`, and every collective of the port
copies its operands to the host, runs there and copies back. That path
is chosen here, once, from the backend and the device; nothing falls
back to it on an error; under it each point-to-point direction keeps
one pinned host buffer per peer and shape.

`all_reduce`, `reduce_scatter_rows` and `all_gather_rows` take
`async_op=True` for the overlap schedulers (optimizer/zero1.py) and
return a `Handle` whose `wait()` gives the result; a transfer that
failed or timed out raises there. Staged, the operand's copy to pinned
host memory runs on a side stream with no wait in the issuing thread,
the gloo op is launched once that copy has landed (launches keep issue
order, and a blocking collective launches every one queued before it),
and the copy back to the device is made in `wait()`. `post_recv`
(`--async_pipeline_dispatch`) posts a receive of the stage ring early,
staged into the second of two pinned buffers a peer, so the next
tick's boundary is in flight while this tick computes.

Tensor-parallel serving (inference/engine.py at serving_tp > 1) runs
under a context of its own, `serving_context`: one tp group over ranks
0..tp-1, installed per thread by `use_mesh` around the engine's rounds
and never process-wide, so rank 0's whole-batch requests outside the
engine run on one rank. Its tp rank 0 drives and sends each round's
host arrays to the other ranks with `broadcast_object`, over a gloo
group of the same ranks whatever the model's backend (the arrays are
host data).

`destroy_parallel` releases the context's groups while the interpreter
runs: a gloo group left for the interpreter's exit to destroy can abort
the process there ("terminate called without an active exception").
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import threading
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

# the JAX package's mesh axis names, as parallel/sharding.py's specs
# name them
DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"

BACKENDS = ("nccl", "gloo")
# a hung collective fails after this long instead of hanging the run
TIMEOUT = datetime.timedelta(minutes=10)

_CONTEXT: Optional["ParallelContext"] = None
_TLS = threading.local()


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def rank_device(device) -> torch.device:
    """A rank's device: `cuda:{LOCAL_RANK % device_count}` for "cuda"
    (every rank of a shared card on cuda:0), the CPU for "cpu"."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", _env_int("LOCAL_RANK", 0)
                        % max(torch.cuda.device_count(), 1))


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, device) -> None:
    """NCCL refuses two ranks on one device and hangs on the attempt:
    raise before it can, naming the backend."""
    if backend not in BACKENDS:
        raise ValueError(f"distributed backend {backend!r}: expected one "
                         f"of {BACKENDS}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices; use gloo "
                         "on the CPU")
    if backend == "nccl":
        local = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
        cards = torch.cuda.device_count()
        if local > cards:
            raise ValueError(
                f"backend nccl: {local} ranks on this host share "
                f"{cards} CUDA device(s), and NCCL cannot put two ranks "
                f"on one device; pass --distributed_backend gloo")


def maybe_initialize_distributed(backend: Optional[str] = None,
                                 device="cuda") -> int:
    """Join the process group torchrun describes (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT in the environment; JAX :125-162). Without
    torchrun's environment, or with a group already made, nothing is
    initialised. Returns the world size."""
    if dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return 1
    device = rank_device(device)
    backend = backend or default_backend(device)
    check_backend(backend, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    return dist.get_world_size()


def build_mesh(dp: int = 1, pp: int = 1, tp: int = 1, cp: int = 1):
    """The (dp, pp, cp, tp) grid of global ranks, tp fastest (JAX
    :164-188): `mesh[d][p][c][t]` is the rank of that coordinate."""
    return [[[[((d * pp + p) * cp + c) * tp + t for t in range(tp)]
              for c in range(cp)] for p in range(pp)] for d in range(dp)]


def coords(rank: int, dp: int, pp: int, cp: int, tp: int) -> tuple:
    """(d, p, c, t) of a global rank in `build_mesh`'s order."""
    t = rank % tp
    c = rank // tp % cp
    p = rank // (tp * cp) % pp
    return rank // (tp * cp * pp), p, c, t


@dataclass
class ParallelContext:
    """The layout, this rank's place in it and its groups (JAX :191-220:
    there a mesh, here process groups). With `world_size == 1` every
    collective of the port is skipped."""

    dp: int = 1
    pp: int = 1
    cp: int = 1
    tp: int = 1
    sequence_parallel: bool = False
    rank: int = 0
    backend: Optional[str] = None
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    tp_group: object = None
    dp_group: object = None
    pp_group: object = None
    cp_group: object = None
    world_group: object = None
    groups: list = field(default_factory=list)
    # global ranks of this rank's pipeline, stage order
    pp_ranks: tuple = (0,)
    # global ranks of this rank's sequence shards, cp order
    cp_ranks: tuple = (0,)
    # point-to-point state: pinned host buffers and sends in flight
    p2p: dict = field(default_factory=dict)
    # a serving context's gloo group for `broadcast_object`
    object_group: object = None

    @property
    def world_size(self) -> int:
        return self.dp * self.pp * self.cp * self.tp

    @property
    def coords(self) -> tuple:
        return coords(self.rank, self.dp, self.pp, self.cp, self.tp)

    @property
    def dp_rank(self) -> int:
        return self.coords[0]

    @property
    def pp_rank(self) -> int:
        return self.coords[1]

    @property
    def cp_rank(self) -> int:
        return self.coords[2]

    @property
    def tp_rank(self) -> int:
        return self.coords[3]

    @property
    def first_stage(self) -> bool:
        return self.pp_rank == 0

    @property
    def last_stage(self) -> bool:
        return self.pp_rank == self.pp - 1

    @property
    def staged(self) -> bool:
        """Collectives go through host memory: gloo with a CUDA
        device."""
        return self.backend == "gloo" and self.device.type == "cuda"


def initialize_parallel(dp: int = 1, pp: int = 1, tp: int = 1,
                        sequence_parallel: bool = False, cp: int = 1,
                        backend: Optional[str] = None,
                        device="cuda") -> ParallelContext:
    """Build the groups and install the context (JAX :223-232). The
    default process group must exist (`maybe_initialize_distributed`,
    torchrun, or `utils/virtual_mesh.spawn_cpu_group`) unless the layout
    is one rank. Every rank calls this with the same arguments."""
    global _CONTEXT
    if min(dp, tp, pp, cp) < 1:
        raise ValueError(f"dp={dp} pp={pp} cp={cp} tp={tp}")
    n = dp * pp * cp * tp
    device = rank_device(device)
    if n == 1 and not dist.is_initialized():
        _CONTEXT = ParallelContext(device=device)
        return _CONTEXT
    if not dist.is_initialized():
        raise RuntimeError(f"a layout of {n} ranks needs the default "
                           f"process group (torchrun, or "
                           f"maybe_initialize_distributed)")
    if dist.get_world_size() != n:
        raise ValueError(f"dp={dp} pp={pp} cp={cp} tp={tp} is {n} ranks; "
                         f"the process group has {dist.get_world_size()}")
    got = dist.get_backend()
    if backend is not None and backend != got:
        raise ValueError(f"backend {backend!r} asked, the process group "
                         f"runs {got!r}")
    check_backend(got, device)
    ctx = ParallelContext(dp=dp, pp=pp, cp=cp, tp=tp,
                          sequence_parallel=sequence_parallel and tp > 1,
                          rank=dist.get_rank(), backend=got, device=device,
                          world_group=dist.group.WORLD)
    mesh = build_mesh(dp, pp, tp, cp)
    d0, p0, c0, t0 = ctx.coords
    # every rank makes every group, in the same order (torch's rule)
    for d in range(dp):
        for p in range(pp):
            for c in range(cp):
                g = dist.new_group(mesh[d][p][c], timeout=TIMEOUT)
                ctx.groups.append(g)
                if (d, p, c) == (d0, p0, c0):
                    ctx.tp_group = g
    for p in range(pp):
        for c in range(cp):
            for t in range(tp):
                g = dist.new_group([mesh[d][p][c][t] for d in range(dp)],
                                   timeout=TIMEOUT)
                ctx.groups.append(g)
                if (p, c, t) == (p0, c0, t0):
                    ctx.dp_group = g
    for d in range(dp):
        for c in range(cp):
            for t in range(tp):
                ranks = [mesh[d][p][c][t] for p in range(pp)]
                g = dist.new_group(ranks, timeout=TIMEOUT)
                ctx.groups.append(g)
                if (d, c, t) == (d0, c0, t0):
                    ctx.pp_group, ctx.pp_ranks = g, tuple(ranks)
    for d in range(dp):
        for p in range(pp):
            for t in range(tp):
                ranks = [mesh[d][p][c][t] for c in range(cp)]
                g = dist.new_group(ranks, timeout=TIMEOUT)
                ctx.groups.append(g)
                if (d, p, t) == (d0, p0, t0):
                    ctx.cp_group, ctx.cp_ranks = g, tuple(ranks)
    _CONTEXT = ctx
    return ctx


def serving_context(tp: int, device="cuda",
                    backend: Optional[str] = None) -> ParallelContext:
    """The context of a tensor-parallel serving engine over the ranks
    0..tp-1 of the default process group, which must hold exactly those
    ranks (torchrun --nproc_per_node tp, or spawn_cpu_group), on this
    rank's `device`. It is returned, not installed: the engine installs
    it for its own rounds (`use_mesh`). Besides the tp group it holds
    `object_group`, a gloo group of the same ranks for
    `broadcast_object`. Every rank calls this at the same point."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != tp:
        raise ValueError(f"serving_tp={tp}: tp serving runs one process a "
                         f"tp rank, in a process group of exactly {tp} "
                         f"(torchrun --nproc_per_node {tp}); this one has "
                         f"{world}")
    got = dist.get_backend()
    if backend is not None and backend != got:
        raise ValueError(f"backend {backend!r} asked, the process group "
                         f"runs {got!r}")
    device = torch.device(device)
    check_backend(got, device)
    ranks = list(range(tp))
    tp_group = dist.new_group(ranks, timeout=TIMEOUT)
    obj_group = dist.new_group(ranks, timeout=TIMEOUT, backend="gloo")
    ctx = ParallelContext(tp=tp, rank=dist.get_rank(), backend=got,
                          device=device, tp_group=tp_group,
                          world_group=tp_group,
                          groups=[tp_group, obj_group])
    ctx.object_group = obj_group
    return ctx


def release_context(ctx: ParallelContext) -> None:
    """Destroy a context's groups now, not when the interpreter exits
    (every rank of them calls this)."""
    if dist.is_initialized():
        for g in ctx.groups:
            dist.destroy_process_group(g)
    ctx.groups.clear()
    ctx.tp_group = ctx.dp_group = ctx.pp_group = ctx.cp_group = None
    ctx.world_group = ctx.object_group = None


def broadcast_object(obj, ctx: ParallelContext, src_rank: int = 0):
    """`obj` (a picklable value: a round's kind and bucket and its small
    host arrays) from tp rank `src_rank` to every rank of `ctx`'s tp
    group: its pickled bytes' length, then the bytes, each one host
    broadcast on the context's gloo object group. Returns the object on
    every rank (the sender's own on the sender)."""
    group = ctx.object_group
    src = dist.get_global_rank(group, src_rank)
    if dist.get_rank() == src:
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        n = torch.tensor([len(data)], dtype=torch.int64)
    else:
        n = torch.zeros(1, dtype=torch.int64)
    dist.broadcast(n, src=src, group=group)
    if dist.get_rank() == src:
        buf = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    else:
        buf = torch.empty(int(n[0]), dtype=torch.uint8)
    dist.broadcast(buf, src=src, group=group)
    if dist.get_rank() == src:
        return obj
    return pickle.loads(buf.numpy().tobytes())


def get_context() -> Optional[ParallelContext]:
    return getattr(_TLS, "ctx", None) or _CONTEXT


def destroy_parallel() -> None:
    """Drop the context and its groups (JAX :239); the default process
    group stays with whoever made it."""
    global _CONTEXT
    ctx, _CONTEXT = _CONTEXT, None
    if ctx is None:
        return
    p2p_wait(ctx)
    release_context(ctx)


@contextlib.contextmanager
def use_mesh(ctx: ParallelContext):
    """Install `ctx` for this thread inside the block (JAX :246-257)."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = prev


# ---------------------------------------------------------------------------
# collectives, staged through the host under gloo with a CUDA device
# ---------------------------------------------------------------------------

def _size(group) -> int:
    return dist.get_world_size(group)


def _staged(ctx, *tensors):
    if ctx is not None and ctx.staged:
        launch_pending(ctx)
        return tuple(t.cpu() for t in tensors)
    return tensors


class Handle:
    """A collective in flight. `wait()` gives its result, once; a
    transfer that failed or timed out raises there.

    Staged (gloo with a CUDA device), the operand's copy to pinned host
    memory runs on a side stream and the gloo op is launched only once
    that copy has landed: at the next issue or wait that finds its event
    done, or at its own `wait()`. Launches keep issue order, so every
    rank runs a group's collectives in the same order; the host copy
    back to the device is made in `wait()`."""

    def __init__(self, ctx, launch, finish, ready=None, keep=()):
        self.ctx = ctx
        self._launch, self._finish = launch, finish
        self._ready = ready  # the CUDA event the host operands wait for
        self._keep = keep  # tensors to hold alive until the launch
        self._work = None
        self._launched = False
        self._done = False
        self._result = None

    @classmethod
    def running(cls, ctx, work, finish) -> "Handle":
        """A handle of an op already launched (`work`, None for none)."""
        h = cls(ctx, None, finish)
        h._work, h._launched = work, True
        return h

    def _start(self) -> None:
        if self._launched:
            return
        if self._ready is not None:
            self._ready.synchronize()
        self._work = self._launch()
        self._launched = True
        self._keep = ()

    def wait(self):
        if self._done:
            return self._result
        if not self._launched:
            launch_pending(self.ctx, upto=self)
        self._start()
        if self._work is not None:
            self._work.wait()
        self._result = self._finish()
        self._done = True
        self._launch = self._finish = None
        return self._result


def done(value) -> Handle:
    """A handle of a value already there (a group of one rank)."""
    return Handle.running(None, None, lambda: value)


def launch_pending(ctx, upto: Optional[Handle] = None) -> None:
    """Launch the staged collectives issued but not launched yet, in
    issue order: all of them (each waits for its host copy), or with
    `upto` those issued before it and it. Every blocking collective of
    a staged context calls this first, so that no op overtakes one
    issued before it."""
    if ctx is None:
        return
    queue = ctx.p2p.get("launch")
    while queue:
        h = queue.pop(0)
        h._start()
        if h is upto:
            return


def _pump(ctx) -> None:
    """Launch, in order, the queued ops whose host copies have landed,
    without waiting for any."""
    queue = ctx.p2p.get("launch")
    while queue and (queue[0]._ready is None or queue[0]._ready.query()):
        queue.pop(0)._start()


def _to_host_async(ctx, x: torch.Tensor):
    """(pinned host copy of x, the event it lands at): the copy runs on
    the context's side stream after the work queued so far on x's
    stream; the issuing thread does not wait."""
    side = ctx.p2p.get("stream")
    if side is None:
        side = ctx.p2p["stream"] = torch.cuda.Stream(device=x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    with torch.cuda.stream(side):
        host.copy_(x, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(side)
    x.record_stream(side)
    return host, ev


def _issue(ctx, x: torch.Tensor, run, finish) -> Handle:
    """An async collective of `x`: `run(operand)` launches it (returns a
    Work), `finish(operand)` makes its result on x's device. Staged, the
    operand is x's pinned host copy and the launch waits for it."""
    if ctx is not None and ctx.staged and x.device.type == "cuda":
        host, ev = _to_host_async(ctx, x)
        h = Handle(ctx, lambda: run(host), lambda: finish(host), ev,
                   keep=(x,))
        ctx.p2p.setdefault("launch", []).append(h)
        _pump(ctx)
        return h
    if ctx is not None and ctx.staged:
        launch_pending(ctx)
    return Handle.running(ctx, run(x), lambda: finish(x))


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM,
               ctx: Optional[ParallelContext] = None,
               async_op: bool = False):
    """`x` reduced over `group` in place (and returned). With `async_op`
    a `Handle` whose `wait()` gives `x` reduced."""
    ctx = ctx or get_context()
    if group is None or _size(group) == 1:
        return done(x) if async_op else x
    if async_op:
        x_c = x if x.is_contiguous() else x.contiguous()

        def finish(h):
            if h is not x:
                x.copy_(h, non_blocking=h.is_pinned())
            return x

        return _issue(ctx, x_c, lambda h: dist.all_reduce(
            h, op=op, group=group, async_op=True), finish)
    (h,) = _staged(ctx, x)
    if not h.is_contiguous():
        h = h.contiguous()
    dist.all_reduce(h, op=op, group=group)
    if h is not x:
        x.copy_(h)
    return x


def _gather_fn():
    # all_gather_single is the newer torch's name of the same call
    return getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor


def all_gather_rows(x: torch.Tensor, group,
                    ctx: Optional[ParallelContext] = None,
                    async_op: bool = False):
    """(n, ...) on each of k ranks -> (k * n, ...), rank order. With
    `async_op` a `Handle` whose `wait()` gives it."""
    ctx = ctx or get_context()
    k = _size(group)
    if k == 1:
        return done(x) if async_op else x
    if async_op:
        box = {}

        def run(h):
            box["out"] = torch.empty((k * h.shape[0],) + tuple(h.shape[1:]),
                                     dtype=h.dtype, device=h.device,
                                     pin_memory=h.is_pinned())
            return _gather_fn()(box["out"], h, group=group, async_op=True)

        return _issue(ctx, x.contiguous(), run, lambda h: box.pop(
            "out").to(x.device, non_blocking=True))
    (h,) = _staged(ctx, x.contiguous())
    out = torch.empty((k * h.shape[0],) + tuple(h.shape[1:]),
                      dtype=h.dtype, device=h.device)
    _gather_fn()(out, h, group=group)
    return out.to(x.device)


def gather_rows(x: torch.Tensor, group,
                ctx: Optional[ParallelContext] = None, axis: int = 0):
    """k ranks' equal pieces of a tensor split along `axis` -> the whole
    tensor on the group's first rank (on the host when staged), None on
    the others. The pieces are joined by one `torch.cat` along `axis`:
    a host tensor is never transposed (a strided copy of a GB-sized
    leaf on one host thread takes seconds)."""
    ctx = ctx or get_context()
    k = _size(group)
    if k == 1:
        return x
    (h,) = _staged(ctx, x.contiguous())
    root = dist.get_global_rank(group, 0)
    parts = [torch.empty_like(h) for _ in range(k)] \
        if dist.get_rank() == root else None
    dist.gather(h, parts, dst=root, group=group)
    return None if parts is None else torch.cat(parts, dim=axis)


def reduce_scatter_rows(x: torch.Tensor, group,
                        ctx: Optional[ParallelContext] = None,
                        async_op: bool = False):
    """(k * n, ...) on each of k ranks -> this rank's (n, ...) block of
    the sum. With `async_op` a `Handle` whose `wait()` gives it."""
    ctx = ctx or get_context()
    k = _size(group)
    if k == 1:
        return done(x) if async_op else x
    if async_op:
        box = {}

        def run(h):
            box["out"] = torch.empty((h.shape[0] // k,) + tuple(h.shape[1:]),
                                     dtype=h.dtype, device=h.device,
                                     pin_memory=h.is_pinned())
            return dist.reduce_scatter_tensor(box["out"], h, group=group,
                                              async_op=True)

        return _issue(ctx, x.contiguous(), run, lambda h: box.pop(
            "out").to(x.device, non_blocking=True))
    (h,) = _staged(ctx, x.contiguous())
    out = torch.empty((h.shape[0] // k,) + tuple(h.shape[1:]),
                      dtype=h.dtype, device=h.device)
    dist.reduce_scatter_tensor(out, h, group=group)
    return out.to(x.device)


def all_to_all_rows(x: torch.Tensor, group,
                    ctx: Optional[ParallelContext] = None) -> torch.Tensor:
    """(k * n, ...): block j goes to rank j; returns the k blocks this
    rank received, stacked in source-rank order."""
    ctx = ctx or get_context()
    if _size(group) == 1:
        return x
    (h,) = _staged(ctx, x.contiguous())
    out = torch.empty_like(h)
    dist.all_to_all_single(out, h, group=group)
    return out.to(x.device)


def sum_over_tokens(x: torch.Tensor,
                    ctx: Optional[ParallelContext] = None) -> torch.Tensor:
    """`x` summed, in place, over the ranks that hold other tokens of the
    same model slice: the dp group (other rows) and the cp group (other
    positions). A loss's numerators and denominators."""
    ctx = ctx or get_context()
    if ctx is None:
        return x
    all_reduce(x, ctx.dp_group, ctx=ctx)
    return all_reduce(x, ctx.cp_group, ctx=ctx)


def barrier(ctx: Optional[ParallelContext] = None) -> None:
    ctx = ctx or get_context()
    if ctx is None or ctx.world_size == 1:
        return
    launch_pending(ctx)
    flag = torch.zeros(1, device="cpu" if ctx.staged or
                       ctx.device.type == "cpu" else ctx.device)
    dist.all_reduce(flag, group=ctx.world_group)


def broadcast(x: torch.Tensor, src: int, group,
              ctx: Optional[ParallelContext] = None) -> torch.Tensor:
    """`x` from global rank `src` to every rank of `group`, in place (and
    returned); every rank passes a tensor of the same shape and dtype."""
    ctx = ctx or get_context()
    if group is None or _size(group) == 1:
        return x
    (h,) = _staged(ctx, x.contiguous())
    dist.broadcast(h, src=src, group=group)
    if h is not x:
        x.copy_(h)
    return x


# ---------------------------------------------------------------------------
# point to point, for the pipeline's stage boundaries
# ---------------------------------------------------------------------------

def _p2p_buffer(ctx, key, shape, dtype):
    """The pinned host buffer of one direction, peer and shape (made at
    first use)."""
    bufs = ctx.p2p.setdefault("buffers", {})
    k = (key, tuple(shape), dtype)
    if k not in bufs:
        bufs[k] = torch.empty(shape, dtype=dtype, device="cpu",
                              pin_memory=True)
    return bufs[k]


def send_boundary(x: torch.Tensor, dst: int,
                  ctx: Optional[ParallelContext] = None) -> None:
    """Send `x` to global rank `dst` without waiting for the receiver.
    Staged: through this peer's pinned host buffer, whose previous send
    is waited for before it is overwritten. Otherwise the tensor is kept
    alive until `p2p_wait`. The receiver calls `recv_boundary` with the
    same shape and dtype, in the same order."""
    ctx = ctx or get_context()
    pending = ctx.p2p.setdefault("pending", {})
    if ctx.staged:
        buf = _p2p_buffer(ctx, ("send", dst), x.shape, x.dtype)
        prev = pending.pop(id(buf), None)
        if prev is not None:
            prev[0].wait()
        buf.copy_(x)
        pending[id(buf)] = (dist.isend(buf, dst), buf)
        return
    x = x.detach().contiguous()
    pending[id(x)] = (dist.isend(x, dst), x)


def recv_boundary(shape, dtype, src: int,
                  ctx: Optional[ParallelContext] = None) -> torch.Tensor:
    """The next tensor global rank `src` sends this rank, a new tensor on
    the context's device."""
    ctx = ctx or get_context()
    if ctx.staged:
        buf = _p2p_buffer(ctx, ("recv", src), shape, dtype)
        dist.recv(buf, src)
        return buf.to(ctx.device)
    out = torch.empty(shape, dtype=dtype, device=ctx.device)
    dist.recv(out, src)
    return out


def post_recv(shape, dtype, src: int,
              ctx: Optional[ParallelContext] = None) -> Handle:
    """A receive of the next tensor global rank `src` sends, posted now
    and waited on later: a `Handle` whose `wait()` gives a new tensor on
    the context's device. Staged, each peer and shape has two pinned
    host buffers used in turn, so the next receive is in flight while
    this one's tensor is read; a buffer is posted again only after its
    copy to the device has landed. Receives from one peer complete in
    the order they were posted, and pair with its sends in that
    order."""
    ctx = ctx or get_context()
    if not ctx.staged:
        out = torch.empty(shape, dtype=dtype, device=ctx.device)
        return Handle.running(ctx, dist.irecv(out, src), lambda: out)
    turns = ctx.p2p.setdefault("turn", {})
    key = (src, tuple(shape), dtype)
    slot = turns.get(key, 0)
    turns[key] = slot + 1
    buf = _p2p_buffer(ctx, ("recv", src, slot % 2), shape, dtype)
    landed = ctx.p2p.setdefault("landed", {})
    ev = landed.pop(id(buf), None)
    if ev is not None:
        ev.synchronize()

    def finish():
        out = buf.to(ctx.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        landed[id(buf)] = ev
        return out

    return Handle.running(ctx, dist.irecv(buf, src), finish)


def p2p_wait(ctx: Optional[ParallelContext] = None) -> None:
    """Wait for every send in flight (a transfer that failed raises)."""
    ctx = ctx or get_context()
    if ctx is None:
        return
    pending = ctx.p2p.pop("pending", {})
    for work, _ in pending.values():
        work.wait()


# ---------------------------------------------------------------------------
# the cp ring, for ring attention
# ---------------------------------------------------------------------------

def ring_shift(xs: list, ctx: Optional[ParallelContext] = None) -> list:
    """Each tensor of `xs` sent to the next rank of the cp group, and the
    previous rank's tensors of the same shapes and dtypes received (new
    tensors on the context's device), in one batch of point-to-point
    operations that every rank of the cp group issues together, so the
    ring cannot deadlock. Staged: through one pinned host buffer per
    direction, position and shape."""
    ctx = ctx or get_context()
    if ctx.cp == 1:
        return list(xs)
    c = ctx.cp_rank
    nxt = ctx.cp_ranks[(c + 1) % ctx.cp]
    prev = ctx.cp_ranks[(c - 1) % ctx.cp]
    ops, recvs = [], []
    for i, x in enumerate(xs):
        x = x.detach().contiguous()
        if ctx.staged:
            send = _p2p_buffer(ctx, ("ring_send", nxt, i), x.shape, x.dtype)
            send.copy_(x)
            recv = _p2p_buffer(ctx, ("ring_recv", prev, i), x.shape,
                               x.dtype)
        else:
            send, recv = x, torch.empty_like(x)
        ops += [dist.P2POp(dist.isend, send, nxt, ctx.cp_group),
                dist.P2POp(dist.irecv, recv, prev, ctx.cp_group)]
        recvs.append(recv)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if ctx.staged:
        return [r.to(ctx.device) for r in recvs]
    return recvs
