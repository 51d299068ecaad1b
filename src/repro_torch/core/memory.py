"""The shared memory pool M and the split-path retrieval from it.

Port of ``repro.core.memory``.  ``lookup`` is the plain gather by a
materialized location tensor: the split backend and the oracle every fused
lookup is held against, bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.device import make_generator, resolve_device


def init_memory(m: int, init: str = "bernoulli", scale: float | None = None,
                dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None,
                device=None) -> torch.Tensor:
    """[m] pool drawn from ``generator`` (a fresh seed-0 generator on
    ``device`` when None).  Bernoulli(0.5) signs follow Theorem 2."""
    dev = resolve_device(device)
    gen = make_generator(0, dev) if generator is None else generator
    s = 1.0 if scale is None else scale
    if init == "bernoulli":
        bits = torch.rand(m, generator=gen, device=dev) < 0.5
        return (torch.where(bits, 1.0, -1.0) * s).to(dtype)
    if init == "normal":
        return (torch.randn(m, generator=gen, device=dev) * s).to(dtype)
    if init == "uniform":
        return ((torch.rand(m, generator=gen, device=dev) * 2 - 1) * s
                ).to(dtype)
    raise ValueError(f"unknown memory init {init!r}")


def lookup(memory: torch.Tensor, locations: torch.Tensor) -> torch.Tensor:
    """E[v, i] = M[A(v)[i]]: memory [m], locations [..., d] -> [..., d]."""
    return memory[locations.long()]
