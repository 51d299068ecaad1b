"""Public wrapper: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.core.allocation import LMAParams
from repro_torch.core.memory import lookup
from repro_torch.kernels.lma_locations.kernel import lma_locations_cuda
from repro_torch.kernels.lma_locations.ref import lma_locations_ref


def lma_locations(params: LMAParams, sets: torch.Tensor) -> torch.Tensor:
    """sets [B, S] int32 bit patterns (PAD = -1) -> [B, d] int32 slots."""
    if sets.is_cuda:
        return lma_locations_cuda(params, sets)
    if sets.device.type == "cpu":
        return lma_locations_ref(params, sets)
    raise ValueError(f"lma_locations: unsupported device {sets.device}")


def lma_gather(params: LMAParams, memory: torch.Tensor,
               sets: torch.Tensor) -> torch.Tensor:
    """The split lookup: kernel locations, then a gather -> [B, d]."""
    return lookup(memory, lma_locations(params, sets))

