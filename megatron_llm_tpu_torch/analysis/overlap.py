"""Gradient-overlap gauges (port of analysis/overlap.py).

The JAX module reads the overlap claim of `--overlap_grad_reduce` /
`--overlap_param_gather` from the compiled HLO: async `-start`/`-done`
pairs with compute between them, and the most collectives in flight at
once. Torch has no compiled schedule to read, so the port measures the
same two facts where they happen, in `optimizer/zero1.GradOverlap`
during the last step:

- `async_pairs`: the async reduce-scatters (quantized: the int8
  exchanges) issued inside the backward while another layer group's
  backward still had to run: each has that compute to hide behind;
- `max_in_flight`: the most of those works issued and not yet waited
  for at once.

These differ from the JAX gauges by definition: the JAX package's CPU
backend lowers no async collective, so its `grad-comm-overlap-pairs` is
a measured 0 on the CPU, where the port's count is the group schedule's
(ROADMAP.md C, accepted divergences). On one card shared by gloo ranks
the works are staged through host memory, so a pair says that the issue
came early, not that the wire overlapped.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["GradOverlapReport", "grad_overlap_report"]


@dataclass(frozen=True)
class GradOverlapReport:
    async_pairs: int = 0
    max_in_flight: int = 0

    def to_dict(self) -> dict:
        return {"async_pairs": self.async_pairs,
                "max_in_flight": self.max_in_flight}


def grad_overlap_report(step_fn) -> GradOverlapReport:
    """The gauges of `step_fn`'s last step (a function from
    `training/train_step.make_train_step`)."""
    gauges = getattr(step_fn, "overlap_gauges", None)
    pairs, peak = gauges() if gauges is not None else (0, 0)
    return GradOverlapReport(async_pairs=pairs, max_in_flight=peak)
