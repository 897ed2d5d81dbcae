"""Per-rank batch rows and exit consensus (port of
parallel/multihost.py).

`process_row_range` is the block of each global microbatch a dp rank
loads: global microbatches are rank-chunks-contiguous, so dp index i
owns rows [i * mbs, (i + 1) * mbs) (JAX :37-71; there a process loads
the rows of the data coordinates its devices hold). `all_hosts_any` and
`host_barrier` are what the train loop calls around its signal,
duration and autoresume exits so that every rank leaves together: an
all-reduce max and a barrier over the world, the identity in one
process.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from megatron_llm_tpu_torch.parallel.mesh import all_reduce, barrier, \
    get_context


def data_axis_span(dp_indices: Sequence[int], rows: int, dp: int
                   ) -> Tuple[int, int]:
    """The contiguous [lo, hi) rows of a (rows = mbs * dp)-row global
    microbatch that the data coordinates `dp_indices` own (JAX
    :37-52)."""
    if rows % dp:
        raise ValueError(f"{rows} rows do not split over dp={dp}")
    per = rows // dp
    idx = sorted(set(dp_indices))
    if not idx or idx != list(range(idx[0], idx[-1] + 1)):
        raise ValueError(f"data coordinates {idx} are not contiguous")
    return idx[0] * per, (idx[-1] + 1) * per


def process_row_range(ctx, rows: int) -> Tuple[int, int]:
    """[lo, hi) rows of each global microbatch this rank loads."""
    if ctx is None or ctx.dp == 1:
        return 0, rows
    return data_axis_span([ctx.dp_rank], rows, ctx.dp)


def _world():
    ctx = get_context()
    return ctx if ctx is not None and ctx.world_size > 1 else None


def all_hosts_any(flag: bool) -> bool:
    """True on every rank iff any rank passed True; in one process, the
    flag itself."""
    ctx = _world()
    if ctx is None:
        return bool(flag)
    dev = "cpu" if ctx.staged or ctx.device.type == "cpu" else ctx.device
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=dev)
    return bool(all_reduce(t, ctx.world_group, op=dist.ReduceOp.MAX,
                           ctx=ctx).item())


def host_barrier(tag: str = "barrier") -> None:
    """Every rank waits here for all of them; in one process, a no-op.
    `tag` names the barrier in errors."""
    del tag
    barrier(_world())


class AutoResume:
    """Sentinel-file termination hook (the TPU analogue of ADLR
    autoresume): every `check_interval` iterations the loop asks whether
    `path` exists (a cluster watchdog touches it before preemption); if
    so, the run checkpoints and exits, and the file is removed so that
    the relaunched job does not leave at once."""

    def __init__(self, path: str, check_interval: int = 50):
        self.path = path
        self.check_interval = max(1, check_interval)

    def termination_requested(self, iteration: int) -> bool:
        if iteration % self.check_interval != 0:
            return False
        local = os.path.exists(self.path)
        hit = all_hosts_any(local)
        if hit and local:
            try:
                os.remove(self.path)
            except FileNotFoundError:
                pass
        return hit
