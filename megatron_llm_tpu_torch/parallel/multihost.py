"""Exit consensus across processes and the autoresume hook (port of
parallel/multihost.py, its single-process part).

`all_hosts_any` and `host_barrier` are what the train loop calls around
its signal, duration and autoresume exits so that every process leaves
together. The port trains in one process: with `torch.distributed`
uninitialised or at world size 1 they are the identity; at a larger
world size they raise, for multi-process training is the parallelism
slice (ROADMAP.md A4).
"""

from __future__ import annotations

import os


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _single_process(what: str) -> None:
    n = _world_size()
    if n > 1:
        raise NotImplementedError(
            f"{what} across {n} processes is not ported yet (the "
            f"parallelism slice, ROADMAP.md A4)")


def all_hosts_any(flag: bool) -> bool:
    """True on every process iff any process passed True; in one process,
    the flag itself."""
    _single_process("all_hosts_any")
    return bool(flag)


def host_barrier(tag: str = "barrier") -> None:
    """Every process waits here for all of them; in one process, a
    no-op. `tag` names the barrier in errors."""
    _single_process(f"host_barrier({tag!r})")


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
