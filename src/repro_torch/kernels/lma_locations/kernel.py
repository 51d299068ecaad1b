"""Binding of ``csrc/lma_locations.cu``: LMA locations on Hopper.

Replaces ``repro/kernels/lma_locations/kernel.py`` (``_locations_kernel``);
the source states the design and what bounds it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.allocation import LMAParams
from repro_torch.core.hashing import MASK
from repro_torch.kernels import build

_I, _U, _P = ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p


@functools.cache
def _launch():
    return build.entry("lma_locations", "lma_locations_launch",
                       [_P, _I, _I, _I, _I, _I, _U, _U, _U, _P, _P])


def lma_locations_cuda(params: LMAParams, sets: torch.Tensor) -> torch.Tensor:
    """sets [N, S] int32 bit patterns (PAD = -1) on the card -> [N, d] int32."""
    build.require(sets, "sets", torch.int32, 2)
    N, S = sets.shape
    out = torch.empty((N, params.d), dtype=torch.int32, device=sets.device)
    with torch.cuda.device(sets.device):
        code = _launch()(build.ptr(sets), N, S, params.d, params.n_h,
                         int(params.independent_hashes), params.seed & MASK,
                         params.m, params.stripe, build.ptr(out),
                         build.stream(sets.device))
    build.check(code, "lma_locations")
    lma_locations_cuda.launches += 1
    return out


lma_locations_cuda.launches = 0
