"""Hand-written CUDA kernels for Hopper, one package per TPU kernel ported.

Each package keeps the reference layout: ``kernel.py`` binds and launches
the CUDA kernel (``csrc/<name>.cu``) and counts its launches, ``ref.py`` is
the plain PyTorch version, and ``ops.py`` dispatches: the plain version for
CPU tensors, the kernel for CUDA tensors (or it raises; never a fallback).
"""

KERNELS = ("lma_locations", "fused_embed", "dot_interaction")
