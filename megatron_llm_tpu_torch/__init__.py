"""PyTorch/CUDA port of megatron_llm_tpu for NVIDIA Hopper (H100).

The JAX package `megatron_llm_tpu` is the reference; this package mirrors
its module paths and names so each function has an obvious counterpart.
It imports torch, numpy and the standard library only, never JAX and never
the JAX package.

Entry points run on `cuda` unless the caller passes `device="cpu"`. Every
Pallas kernel on the ported path is a kernel written by hand for sm_90a
(CUDA C++ under `csrc/`, or Triton), each beside its plain PyTorch
version; the plain version serves CPU tensors only.
"""
