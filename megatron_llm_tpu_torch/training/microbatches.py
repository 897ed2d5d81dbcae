"""Microbatch calculators (port of training/microbatches.py, a host-only
copy; ref: megatron/microbatches.py).

`ConstantNumMicroBatches` (:59) and the linear global-batch-size ramp
`RampupBatchsizeNumMicroBatches` (:79-160): global batch grows from
`start` by `increment` every `ramp_samples` consumed samples.
"""

from __future__ import annotations

from typing import Optional, Sequence


class NumMicroBatchesCalculator:
    def __init__(self):
        self.num_micro_batches: int = 1
        self.current_global_batch_size: int = 1

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    def update(self, consumed_samples: int, consistency_check: bool = True):
        pass


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    """ref: microbatches.py:59-78."""

    def __init__(self, global_batch_size: int, micro_batch_size: int,
                 data_parallel_size: int):
        super().__init__()
        micro_times_dp = micro_batch_size * data_parallel_size
        assert global_batch_size % micro_times_dp == 0, (
            f"global batch {global_batch_size} not divisible by "
            f"micro_batch*dp {micro_times_dp}"
        )
        self.num_micro_batches = global_batch_size // micro_times_dp
        assert self.num_micro_batches >= 1
        self.current_global_batch_size = global_batch_size


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    """ref: microbatches.py:79-160 — batch ramps `start -> global` in
    `increment` steps spread over `ramp_samples` consumed samples."""

    def __init__(
        self,
        start_batch_size: int,
        batch_size_increment: int,
        ramp_samples: int,
        global_batch_size: int,
        micro_batch_size: int,
        data_parallel_size: int,
    ):
        super().__init__()
        assert global_batch_size > 0 and start_batch_size > 0
        assert batch_size_increment > 0 and ramp_samples >= 0
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel = micro_batch_size * data_parallel_size
        assert start_batch_size % self.micro_batch_times_data_parallel == 0
        assert batch_size_increment % self.micro_batch_times_data_parallel == 0
        assert global_batch_size % self.micro_batch_times_data_parallel == 0
        self.start_batch_size = start_batch_size
        self.batch_size_increment = batch_size_increment
        self.global_batch_size = global_batch_size
        diff = global_batch_size - start_batch_size
        assert diff >= 0 and diff % batch_size_increment == 0
        num_increments = diff // batch_size_increment
        self.rampup_samples_per_increment = ramp_samples / max(num_increments, 1)
        self.update(0, consistency_check=False)

    def update(self, consumed_samples: int, consistency_check: bool = True):
        steps = int(consumed_samples / self.rampup_samples_per_increment)
        self.current_global_batch_size = min(
            self.start_batch_size + steps * self.batch_size_increment,
            self.global_batch_size,
        )
        if consistency_check:
            assert (
                self.current_global_batch_size
                % self.micro_batch_times_data_parallel
                == 0
            )
        self.num_micro_batches = (
            self.current_global_batch_size // self.micro_batch_times_data_parallel
        )


def iterations_for_samples(
    target_samples: int,
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
    rampup_batch_size: Optional[Sequence[int]] = None,
) -> int:
    """Exact iteration count to consume `target_samples` under the (possibly
    ramping) batch schedule — what the reference computes by stepping
    update_num_microbatches over train_samples (training.py:126-141).
    Walks the ramp phase step by step, then closes arithmetically."""
    calc = build_num_microbatches_calculator(
        global_batch_size, micro_batch_size, data_parallel_size,
        rampup_batch_size,
    )
    consumed, iters = 0, 0
    while consumed < target_samples:
        bs = calc.get_current_global_batch_size()
        if bs >= global_batch_size:  # ramp done (or constant): close out
            remaining = target_samples - consumed
            return iters + -(-remaining // bs)
        consumed += bs
        iters += 1
        calc.update(consumed, consistency_check=False)
    return iters


def build_num_microbatches_calculator(
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
    rampup_batch_size: Optional[Sequence[int]] = None,
) -> NumMicroBatchesCalculator:
    """ref: build_num_microbatches_calculator (microbatches.py:14-56)."""
    if rampup_batch_size is None:
        return ConstantNumMicroBatches(
            global_batch_size, micro_batch_size, data_parallel_size
        )
    assert len(rampup_batch_size) == 3
    return RampupBatchsizeNumMicroBatches(
        int(rampup_batch_size[0]), int(rampup_batch_size[1]),
        int(rampup_batch_size[2]), global_batch_size, micro_batch_size,
        data_parallel_size,
    )
