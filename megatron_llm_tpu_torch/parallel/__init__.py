"""Parallelism on torch.distributed: process groups, the tensor- and
sequence-parallel collectives, parameter sharding, the vocab-parallel
cross entropy and the per-rank data rows."""
