"""Binding of ``csrc/fused_embed.cu``: the fused lookup on Hopper.

Replaces ``repro/kernels/fused_embed/kernel.py`` (``_fwd_kernel``, flat and
bag-pooled); the source states the design and what bounds it.  Forward
only: the backward kernels come with the training slice, so a launch on a
pool that needs a gradient raises instead of returning a detached result.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.hashing import MASK
from repro_torch.kernels import build

_I, _U, _P = ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p
SCHEME_IDS = {"lma": 0, "hashed_elem": 1, "hashed_row": 2}


@functools.cache
def _launch():
    return build.entry("fused_embed", "fused_lookup_launch",
                       [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _U,
                        _U, _U, _I, _P, _P])


def fused_lookup_cuda(spec, memory: torch.Tensor, gids: torch.Tensor,
                      sets: torch.Tensor | None = None,
                      support: torch.Tensor | None = None,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """Flat: gids [N] (+ sets [N, S], support [N]) -> [N, d].
    Bag: gids [B, L] (+ sets [B, L, S], support [B, L]), weights [B, L]
    -> [B, d].  Ids, sets (int32 bit patterns, PAD = -1) and support are
    int32; memory [spec.m] and weights float32; all contiguous on the card."""
    pool = weights is not None
    build.require(memory, "memory", torch.float32, 1)
    build.require(gids, "gids", torch.int32, 2 if pool else 1)
    if memory.shape[0] != spec.m:
        raise ValueError(f"memory has {memory.shape[0]} slots, spec {spec.m}")
    if torch.is_grad_enabled() and memory.requires_grad:
        raise RuntimeError("fused_lookup_cuda has no backward kernel yet; "
                           "call it under torch.no_grad() or inference_mode")
    B, L = gids.shape if pool else (gids.shape[0], 1)
    S = 0
    if spec.scheme == "lma":
        build.require(sets, "sets", torch.int32, gids.dim() + 1)
        build.require(support, "support", torch.int32, gids.dim())
        if sets.shape[:-1] != gids.shape or support.shape != gids.shape:
            raise ValueError("sets/support do not match gids")
        S = sets.shape[-1]
    else:
        sets = support = None
    if pool:
        build.require(weights, "weights", torch.float32, 2)
        if weights.shape != gids.shape:
            raise ValueError("weights do not match gids")
    out = torch.empty((B, spec.d), dtype=torch.float32, device=memory.device)
    with torch.cuda.device(memory.device):
        code = _launch()(
            build.ptr(sets), build.ptr(gids), build.ptr(support),
            build.ptr(weights), build.ptr(memory), B, L, S,
            SCHEME_IDS[spec.scheme], spec.d, spec.n_h, int(spec.independent),
            spec.seed & MASK, spec.m, spec.stripe, spec.min_support,
            build.ptr(out), build.stream(memory.device))
    build.check(code, "fused_lookup")
    fused_lookup_cuda.launches += 1
    return out


fused_lookup_cuda.launches = 0
