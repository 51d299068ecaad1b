"""Binding of ``csrc/fused_embed.cu``: the fused embedding engine on Hopper.

Replaces ``repro/kernels/fused_embed/kernel.py``: ``_fwd_kernel`` (flat and
bag-pooled lookup), ``_locations_kernel``, ``_scatter_kernel``,
``_weight_grad_kernel`` and the chunked exchange's ``_chunk_fwd_kernel``,
``_gather_loc_kernel`` and ``_scatter_loc_kernel``; the source states the
design and what bounds it.  These are the raw launches (no autograd);
``ops.py`` builds the gradients from them.  Each wrapper counts its launches
in ``<fn>.launches``.  The lookup, the locations, the chunk lookup and the
scatter-add share one walk of (row, column tile) units; ``tile`` is the
columns a warp covers (``lookup_tile``; the first three take ``tile=`` to
force one), and every tile gives the same bits.

Slab mode: the lookup, the scatter-add and the chunk kernels take the pool
(or its gradient) as one rank's ``[m_local]`` slab starting at global slot
``base``; out-of-slab locations gather 0 and scatter nothing.  ``base=0``
with the whole ``[spec.m]`` pool is the single-card case.
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


def _check_pool(spec, memory, base: int | None = None) -> int:
    """The whole ``[spec.m]`` pool (``base`` None), or a slab that lies in
    it; -> the slab's base."""
    build.require(memory, "memory", torch.float32, 1)
    if base is None:
        if memory.shape[0] != spec.m:
            raise ValueError(f"memory has {memory.shape[0]} slots, spec "
                             f"{spec.m}")
        return 0
    _check_slab(spec.m, memory.shape[0], base)
    return base


def _check_slab(m: int, m_local: int, base: int):
    """A slab of ``m_local`` slots from ``base`` within a pool of ``m``;
    the whole pool when base is 0 and m_local is m."""
    if not (0 <= base and 0 < m_local and base + m_local <= m):
        raise ValueError(f"a slab of {m_local} slots from {base} does not "
                         f"lie in a pool of {m}")


WARPS_PER_BLOCK = 8               # csrc/fused_embed.cu


def lookup_tile(B: int, d: int, sms: int) -> int:
    """Columns one warp covers, a tile of a row, in the lookup, the
    locations and the chunk lookup (``B`` rows): ``d``, one tile a row,
    when ceil(B / 8) blocks of 8 warps fill the card's ``sms`` SMs (every
    recsys, train_4k and prefill launch); else 32 (or ``d`` when narrower),
    so that an LM's few decode tokens or a rank's few-row chunk spread over
    the card."""
    return d if -(-B // WARPS_PER_BLOCK) >= sms else min(32, d)


def _tile(spec, rows: int, tile: int | None, device) -> int:
    """``tile``, or by default ``lookup_tile``'s for ``rows`` on ``device``;
    raises unless it is d or a positive multiple of 32."""
    if tile is None:
        return lookup_tile(rows, spec.d, sm_count(device.index))
    if not (tile == spec.d or (tile > 0 and tile % 32 == 0)):
        raise ValueError(f"tile {tile}: neither d = {spec.d} nor a positive "
                         f"multiple of 32")
    return tile


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_lookup_cuda(spec, memory: torch.Tensor, gids: torch.Tensor,
                      sets: torch.Tensor | None = None,
                      support: torch.Tensor | None = None,
                      weights: torch.Tensor | None = None,
                      base: int | None = None,
                      tile: int | None = None) -> torch.Tensor:
    """Flat: gids [N] (+ sets [N, S], support [N]) -> [N, d].
    Bag: gids [B, L] (+ sets [B, L, S], support [B, L]), weights [B, L]
    -> [B, d].  Ids, sets (int32 bit patterns, PAD = -1) and support are
    int32; memory [spec.m] (or the [m_local] slab from ``base``) and
    weights float32; all contiguous on the card.  ``tile``: the columns a
    warp covers (d, or a multiple of 32), by default ``lookup_tile``'s; any
    tile gives the same bits."""
    pool = weights is not None
    base = _check_pool(spec, memory, base)
    sets, support, S = _value_inputs(spec, gids, sets, support,
                                     2 if pool else 1)
    B, L = gids.shape if pool else (gids.shape[0], 1)
    if pool:
        build.require(weights, "weights", torch.float32, 2)
        if weights.shape != gids.shape:
            raise ValueError("weights do not match gids")
    tile = _tile(spec, B, tile, memory.device)
    out = torch.empty((B, spec.d), dtype=torch.float32, device=memory.device)
    with torch.cuda.device(memory.device):
        code = _entry("fused_lookup_launch", (_P,) * 5 + (_I,) * 6)(
            build.ptr(sets), build.ptr(gids), build.ptr(support),
            build.ptr(weights), build.ptr(memory), B, L, S, base,
            memory.shape[0], tile, *_spec_args(spec), build.ptr(out),
            build.stream(memory.device))
    build.check(code, "fused_lookup")
    fused_lookup_cuda.launches += 1
    return out


def fused_locations_cuda(spec, gids: torch.Tensor,
                         sets: torch.Tensor | None = None,
                         support: torch.Tensor | None = None,
                         tile: int | None = None) -> torch.Tensor:
    """gids [N] (+ sets [N, S], support [N]) -> [N, d] int32 locations.
    ``tile``: the columns a warp covers, as ``fused_lookup_cuda``'s (by
    default ``lookup_tile``'s: 32 for a few-row chunk, d when the rows fill
    the card); any tile gives the same bits."""
    sets, support, S = _value_inputs(spec, gids, sets, support, 1)
    N = gids.shape[0]
    tile = _tile(spec, N, tile, gids.device)
    out = torch.empty((N, spec.d), dtype=torch.int32, device=gids.device)
    with torch.cuda.device(gids.device):
        code = _entry("fused_locations_launch", (_P,) * 3 + (_I,) * 3)(
            build.ptr(sets), build.ptr(gids), build.ptr(support), N, S, tile,
            *_spec_args(spec), build.ptr(out), build.stream(gids.device))
    build.check(code, "fused_locations")
    fused_locations_cuda.launches += 1
    return out


def fused_scatter_add_cuda(spec, g: torch.Tensor, gids: torch.Tensor,
                           sets: torch.Tensor | None = None,
                           support: torch.Tensor | None = None,
                           weights: torch.Tensor | None = None,
                           base: int = 0, m_local: int | None = None
                           ) -> torch.Tensor:
    """The lookup's pool gradient, locations recomputed: flat g [N, d] with
    gids [N] (+ sets, support), or bag g [B, d] with gids [B, L] and
    weights [B, L] -> dM [spec.m] float32 (``dM[loc] += g``, bag
    ``+= g * w``); in slab mode dM [m_local] from ``base``, in-slab
    locations only.  dM comes from ``torch.empty``: the kernel zeroes it
    under its hashing, on a cooperative grid of ``scatter_grid`` blocks
    over the lookup's (row, ``lookup_tile``) units; a refused launch
    raises."""
    if m_local is None:
        m_local = spec.m
    _check_slab(spec.m, m_local, base)
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
    tile = _tile(spec, B, None, g.device)
    dmem = torch.empty(m_local, dtype=torch.float32, device=g.device)
    # the grid's tail counter, which the kernel sets before its barrier
    tail = torch.empty(1, dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        code = _entry("fused_scatter_add_launch", (_P,) * 6 + (_I,) * 7)(
            build.ptr(sets), build.ptr(gids), build.ptr(support),
            build.ptr(weights), build.ptr(g), build.ptr(tail), B, L, S, base,
            m_local, tile, scatter_grid(g.device.index, S),
            *_spec_args(spec), build.ptr(dmem), build.stream(g.device))
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


def fused_chunk_lookup_cuda(spec, memory: torch.Tensor, gids: torch.Tensor,
                            sets: torch.Tensor | None = None,
                            support: torch.Tensor | None = None,
                            base: int = 0, tile: int | None = None):
    """One exchange chunk: gids [c] (+ sets [c, S], support [c]) -> (the
    slab-masked partial [c, d] float32, the locations [c, d] int32), memory
    the [m_local] slab from ``base``.  ``tile`` as ``fused_locations_cuda``'s;
    any tile gives the same bits."""
    _check_pool(spec, memory, base)
    sets, support, S = _value_inputs(spec, gids, sets, support, 1)
    N = gids.shape[0]
    tile = _tile(spec, N, tile, gids.device)
    part = torch.empty((N, spec.d), dtype=torch.float32, device=gids.device)
    loc = torch.empty((N, spec.d), dtype=torch.int32, device=gids.device)
    with torch.cuda.device(gids.device):
        code = _entry("fused_chunk_lookup_launch",
                      (_P,) * 4 + (_I,) * 5 + (_P,))(
            build.ptr(sets), build.ptr(gids), build.ptr(support),
            build.ptr(memory), N, S, base, memory.shape[0], tile,
            build.ptr(loc), *_spec_args(spec), build.ptr(part),
            build.stream(gids.device))
    build.check(code, "fused_chunk_lookup")
    fused_chunk_lookup_cuda.launches += 1
    return part, loc


def blocks_per_sm(kernel: str, S: int, tile: int, bag: bool = False) -> int:
    """Blocks of 8 warps an SM holds for ``kernel`` ("lookup",
    "locations", "chunk_lookup" or "scatter") at its registers and its
    shared memory for sets of ``S`` words (a bag: and tiles of ``tile``
    sums; the scatter: and its staged slots), from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on the current
    card."""
    blocks = ctypes.c_int(0)
    code = build.entry("fused_embed", "fused_blocks_per_sm",
                       [_I, _I, _I, _I, ctypes.c_void_p])(
        ("lookup", "locations", "chunk_lookup", "scatter").index(kernel), S,
        tile, int(bag), ctypes.byref(blocks))
    build.check(code, f"fused_blocks_per_sm({kernel})")
    return blocks.value


@functools.cache
def scatter_grid(index: int, S: int) -> int:
    """The scatter-add's cooperative grid on card ``index`` for sets of
    ``S`` words: every block the card holds at once (``blocks_per_sm``
    times the SM count), whatever the row count, so that the pool's fill
    spreads over every SM."""
    with torch.cuda.device(index):
        return blocks_per_sm("scatter", S, 0) * sm_count(index)


def fused_chunk_gather_cuda(memory: torch.Tensor, loc: torch.Tensor,
                            base: int = 0) -> torch.Tensor:
    """loc [c, d] int32 global locations -> [c, d] float32, the slab-masked
    gather from the [m_local] slab ``memory`` that starts at ``base``."""
    build.require(memory, "memory", torch.float32, 1)
    build.require(loc, "loc", torch.int32, 2)
    if base < 0:
        raise ValueError(f"slab base {base} < 0")
    out = torch.empty(loc.shape, dtype=torch.float32, device=loc.device)
    with torch.cuda.device(loc.device):
        code = build.entry("fused_embed", "fused_chunk_gather_launch",
                           [_P, ctypes.c_int64, _P, _I, _I, _P, _P])(
            build.ptr(loc), loc.numel(), build.ptr(memory), base,
            memory.shape[0], build.ptr(out), build.stream(loc.device))
    build.check(code, "fused_chunk_gather")
    fused_chunk_gather_cuda.launches += 1
    return out


def fused_chunk_scatter_cuda(loc: torch.Tensor, g: torch.Tensor, base: int,
                             m_local: int) -> torch.Tensor:
    """g [c, d] float32 at the locations loc [c, d] int32 -> dM [m_local]
    float32, ``dM[loc - base] += g`` for in-slab locations only."""
    build.require(loc, "loc", torch.int32, 2)
    build.require(g, "g", torch.float32, 2)
    if g.shape != loc.shape:
        raise ValueError(f"g {tuple(g.shape)} does not match loc "
                         f"{tuple(loc.shape)}")
    if base < 0 or m_local <= 0:
        raise ValueError(f"a slab of {m_local} slots from {base}")
    dmem = torch.zeros(m_local, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        code = build.entry("fused_embed", "fused_chunk_scatter_launch",
                           [_P, _P, ctypes.c_int64, _I, _I, _P, _P])(
            build.ptr(loc), build.ptr(g), loc.numel(), base, m_local,
            build.ptr(dmem), build.stream(g.device))
    build.check(code, "fused_chunk_scatter")
    fused_chunk_scatter_cuda.launches += 1
    return dmem


fused_lookup_cuda.launches = 0
fused_locations_cuda.launches = 0
fused_scatter_add_cuda.launches = 0
fused_weight_grad_cuda.launches = 0
fused_chunk_lookup_cuda.launches = 0
fused_chunk_gather_cuda.launches = 0
fused_chunk_scatter_cuda.launches = 0
