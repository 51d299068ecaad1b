"""Binding of ``csrc/fused_embed.cu``: the fused embedding engine on Hopper.

Replaces ``repro/kernels/fused_embed/kernel.py``: ``_fwd_kernel`` (flat and
bag-pooled lookup), ``_locations_kernel``, ``_scatter_kernel`` and
``_weight_grad_kernel``; the source states the design and what bounds it.
These are the raw launches (no autograd); ``ops.py`` builds the gradients
from them.  Each wrapper counts its launches in ``<fn>.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.hashing import MASK
from repro_torch.kernels import build

_I, _U, _P = ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p
SCHEME_IDS = {"lma": 0, "hashed_elem": 1, "hashed_row": 2}
# (scheme, d, n_h, independent, seed, m, stripe, min_support), then the
# output pointer and the stream, close every entry point's arguments
_TAIL = [_I, _I, _I, _I, _U, _U, _U, _I, _P, _P]


@functools.cache
def _entry(symbol: str, head: tuple):
    return build.entry("fused_embed", symbol, list(head) + _TAIL)


def _spec_args(spec) -> tuple:
    return (SCHEME_IDS[spec.scheme], spec.d, spec.n_h, int(spec.independent),
            spec.seed & MASK, spec.m, spec.stripe, spec.min_support)


def _value_inputs(spec, gids, sets, support, rank: int):
    """Check ids (+ lma sets and support) of rank ``rank``; -> (sets,
    support, S) with None and 0 for the hashed schemes."""
    build.require(gids, "gids", torch.int32, rank)
    if spec.scheme != "lma":
        return None, None, 0
    build.require(sets, "sets", torch.int32, rank + 1)
    build.require(support, "support", torch.int32, rank)
    if sets.shape[:-1] != gids.shape or support.shape != gids.shape:
        raise ValueError("sets/support do not match gids")
    return sets, support, sets.shape[-1]


def _check_pool(spec, memory):
    build.require(memory, "memory", torch.float32, 1)
    if memory.shape[0] != spec.m:
        raise ValueError(f"memory has {memory.shape[0]} slots, spec {spec.m}")


def fused_lookup_cuda(spec, memory: torch.Tensor, gids: torch.Tensor,
                      sets: torch.Tensor | None = None,
                      support: torch.Tensor | None = None,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """Flat: gids [N] (+ sets [N, S], support [N]) -> [N, d].
    Bag: gids [B, L] (+ sets [B, L, S], support [B, L]), weights [B, L]
    -> [B, d].  Ids, sets (int32 bit patterns, PAD = -1) and support are
    int32; memory [spec.m] and weights float32; all contiguous on the card."""
    pool = weights is not None
    _check_pool(spec, memory)
    sets, support, S = _value_inputs(spec, gids, sets, support,
                                     2 if pool else 1)
    B, L = gids.shape if pool else (gids.shape[0], 1)
    if pool:
        build.require(weights, "weights", torch.float32, 2)
        if weights.shape != gids.shape:
            raise ValueError("weights do not match gids")
    out = torch.empty((B, spec.d), dtype=torch.float32, device=memory.device)
    with torch.cuda.device(memory.device):
        code = _entry("fused_lookup_launch", (_P,) * 5 + (_I,) * 3)(
            build.ptr(sets), build.ptr(gids), build.ptr(support),
            build.ptr(weights), build.ptr(memory), B, L, S,
            *_spec_args(spec), build.ptr(out), build.stream(memory.device))
    build.check(code, "fused_lookup")
    fused_lookup_cuda.launches += 1
    return out


def fused_locations_cuda(spec, gids: torch.Tensor,
                         sets: torch.Tensor | None = None,
                         support: torch.Tensor | None = None) -> torch.Tensor:
    """gids [N] (+ sets [N, S], support [N]) -> [N, d] int32 locations."""
    sets, support, S = _value_inputs(spec, gids, sets, support, 1)
    N = gids.shape[0]
    out = torch.empty((N, spec.d), dtype=torch.int32, device=gids.device)
    with torch.cuda.device(gids.device):
        code = _entry("fused_locations_launch", (_P,) * 3 + (_I,) * 2)(
            build.ptr(sets), build.ptr(gids), build.ptr(support), N, S,
            *_spec_args(spec), build.ptr(out), build.stream(gids.device))
    build.check(code, "fused_locations")
    fused_locations_cuda.launches += 1
    return out


def fused_scatter_add_cuda(spec, g: torch.Tensor, gids: torch.Tensor,
                           sets: torch.Tensor | None = None,
                           support: torch.Tensor | None = None,
                           weights: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """The lookup's pool gradient, locations recomputed: flat g [N, d] with
    gids [N] (+ sets, support), or bag g [B, d] with gids [B, L] and
    weights [B, L] -> dM [spec.m] float32 (``dM[loc] += g``, bag
    ``+= g * w``)."""
    pool = weights is not None
    sets, support, S = _value_inputs(spec, gids, sets, support,
                                     2 if pool else 1)
    B, L = gids.shape if pool else (gids.shape[0], 1)
    build.require(g, "g", torch.float32, 2)
    if g.shape != (B, spec.d):
        raise ValueError(f"g has shape {tuple(g.shape)}, want {(B, spec.d)}")
    if pool:
        build.require(weights, "weights", torch.float32, 2)
        if weights.shape != gids.shape:
            raise ValueError("weights do not match gids")
    dmem = torch.zeros(spec.m, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        code = _entry("fused_scatter_add_launch", (_P,) * 5 + (_I,) * 3)(
            build.ptr(sets), build.ptr(gids), build.ptr(support),
            build.ptr(weights), build.ptr(g), B, L, S, *_spec_args(spec),
            build.ptr(dmem), build.stream(g.device))
    build.check(code, "fused_scatter_add")
    fused_scatter_add_cuda.launches += 1
    return dmem


def fused_weight_grad_cuda(spec, memory: torch.Tensor, g: torch.Tensor,
                           gids: torch.Tensor,
                           sets: torch.Tensor | None = None,
                           support: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """The bag's weight gradient: g [B, d], gids [B, L] (+ sets, support)
    -> dw [B, L] with ``dw[b, l] = <g[b], M[loc[b, l]]>``."""
    _check_pool(spec, memory)
    sets, support, S = _value_inputs(spec, gids, sets, support, 2)
    B, L = gids.shape
    build.require(g, "g", torch.float32, 2)
    if g.shape != (B, spec.d):
        raise ValueError(f"g has shape {tuple(g.shape)}, want {(B, spec.d)}")
    dw = torch.empty((B, L), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        code = _entry("fused_weight_grad_launch", (_P,) * 5 + (_I,) * 3)(
            build.ptr(sets), build.ptr(gids), build.ptr(support),
            build.ptr(memory), build.ptr(g), B, L, S, *_spec_args(spec),
            build.ptr(dw), build.stream(g.device))
    build.check(code, "fused_weight_grad")
    fused_weight_grad_cuda.launches += 1
    return dw


fused_lookup_cuda.launches = 0
fused_locations_cuda.launches = 0
fused_scatter_add_cuda.launches = 0
fused_weight_grad_cuda.launches = 0
