"""PyTorch/CUDA port of the DABench-LLM reproduction.

A package of its own beside the JAX reference ``repro``, with the same
module layout; it imports ``torch`` and nothing of ``jax`` or ``repro``.
Entry points run on a CUDA device unless the caller passes
``device="cpu"``; on the CPU every hand-written kernel is replaced by its
plain PyTorch version (:mod:`repro_torch.kernels.ref`).
"""
