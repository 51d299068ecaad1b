"""Sharded common-memory lookups and sparse updates, on one rank (port of
``repro.dist.sharded_memory``, dense D' store only).

The pool M ([m] floats) is sharded over the 'model' axis: rank r of P holds
the contiguous slab ``[r * m / P, (r + 1) * m / P)``, and for LMA the rows of
the D' store are sharded the same way.  Each driver here is the body of the
reference's ``shard_map``: it takes this rank's slab (and store rows) and
the whole batch's global ids (a 'data' axis of 1: every rank sees the whole
batch) and runs the cross-rank traffic through an
:class:`~repro_torch.dist.exchange.Exchange`:

``psum``        the slab-mode lookup kernel over the whole batch (LMA's
                set rows first reconstructed by psum), then one
                all-reduce;
``ring``        a chunk's locations and own-slab gather in one kernel, then
                the masked gather of each visiting chunk;
``all_to_all``  the chunk's locations kernel, one masked gather of the whole
                batch, one all-reduce.

All three are bit-identical to the single-device lookup.  The kernels run
on the card; for a pool on the CPU ``kernels/fused_embed/ops.py`` runs their
plain versions in the same places.  The strategy is the cost model's, or
the one ``REPRO_DIST_EXCHANGE`` (``exchange.FORCED``) pins.  A driver returns
a :class:`SlabLookup`: the output, the whole batch's locations (which the
sparse gradient records: the exchange assembled them anyway) and the slab's
gradient.  The backward differs from the reference's, which transposes the
collectives: with a 'data' axis of 1 every rank holds the same cotangent of
the whole batch, so each scatters it into its own slab by the whole batch's
locations, in one launch and with no collective (the chunk scatter kernel,
or for psum the slab-mode scatter-add, which recomputes the locations).
That is the single-device gradient restricted to the slab.

The sparse update (``sharded_sparse_update`` / ``sharded_sparse_apply``):
each rank applies a masked local update to its own slab; off-slab entries
go to the sentinel ``n_local`` and are dropped.  A stripe-major bucketed
stream whose stripes tile the slabs (``slab_aligned``) gives each rank its
K/P slice, which holds every entry of its slab, and needs no collective.

Not ported: the CSR-store drivers (the port has no CSR store).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.core import allocation as alc
from repro_torch.core.allocation import LMAParams
from repro_torch.core.memory import lookup as plain_lookup
from repro_torch.core.signatures import DenseSignatureStore
from repro_torch.dist import collectives as col
from repro_torch.dist import exchange as exl
from repro_torch.dist.context import Mesh
from repro_torch.kernels.fused_embed import ops as fe


@dataclasses.dataclass
class SlabLookup:
    """One sharded lookup on this rank."""

    out: torch.Tensor                                # [..., d], every rank
    locations: Callable[[], torch.Tensor]            # () -> [n, d] global
    scatter: Callable[[torch.Tensor], torch.Tensor]  # g -> [m_local] grad
    strategy: str


class _SlabGrad(torch.autograd.Function):
    """Forward: a sharded lookup.  Backward: its slab gradient."""

    @staticmethod
    def forward(ctx, memory, run):
        ctx.res = run()
        return ctx.res.out

    @staticmethod
    def backward(ctx, g):
        d = ctx.res.out.shape[-1]
        return ctx.res.scatter(g.reshape(-1, d).contiguous()), None


def attach(memory: torch.Tensor, run: Callable[[], SlabLookup]
           ) -> torch.Tensor:
    """Run ``run()`` (a driver call) as the forward of an autograd node of
    ``memory`` whose backward is the result's ``scatter``."""
    return _SlabGrad.apply(memory, run)


def _slab(memory: torch.Tensor, mesh: Mesh, m: int) -> tuple[int, int]:
    """(base, m_local) of this rank's slab of an [m] pool."""
    m_local = int(memory.shape[0])
    if m_local * mesh.model != m:
        raise ValueError(f"a slab of {m_local} slots is not 1/{mesh.model} "
                         f"of a pool of {m}")
    return mesh.rank * m_local, m_local


def _result(out, loc, base: int, m_local: int, name: str,
            shape) -> SlabLookup:
    """A lookup whose backward scatters by the whole batch's locations."""
    return SlabLookup(out.reshape(*shape, loc.shape[-1]), lambda: loc,
                      lambda g: fe.fused_chunk_scatter(loc, g, base, m_local),
                      name)


def _unsharded(memory, loc, shape) -> SlabLookup:
    """No 'model' axis to shard over: the plain lookup of the whole pool."""
    out = plain_lookup(memory, loc)
    return _result(out, loc, 0, int(memory.shape[0]), "none", shape)


def _resolve(mesh, n_flat: int, d: int, m: int | None,
             alloc_row: float | None = None) -> exl.Exchange:
    """``REPRO_DIST_EXCHANGE`` > cost model, with psum where the chosen
    strategy cannot split the batch.  Given ``m``, the fused flags come
    from the gates, which every slab ``_slab`` accepts passes."""
    ex = exl.resolve_exchange(mesh, B=n_flat, d=d, m=m, alloc_row=alloc_row)
    return ex if ex.eligible(n_flat, mesh.model) else exl.PSUM


def _chunk_engine(spec, base: int, inputs_fn=None) -> exl.FusedChunkEngine:
    """The chunked strategies' engine: the chunk's location math runs in
    the kernels of ``spec`` (the scheme's FusedSpec), ``inputs_fn(g) ->
    (sets, support)`` supplying its inputs (LMA's set reconstruction, a
    uniform collective)."""
    def gather(mem_l, loc):
        return fe.fused_chunk_gather(mem_l, loc, base)

    def inputs(g):
        return inputs_fn(g) if inputs_fn is not None else (None, None)

    def chunk_lookup(mem_l, g):
        return fe.fused_chunk_lookup(spec, mem_l, g, *inputs(g), base=base)

    def locations(g):
        return fe.fused_locations(spec, g, *inputs(g))

    return exl.FusedChunkEngine(chunk_lookup, locations, gather)


@torch.no_grad()
def sharded_set_lookup(table: torch.Tensor, gids: torch.Tensor,
                       mesh: Mesh) -> torch.Tensor:
    """Rows of a 'model'-row-sharded integer table (this rank's rows in
    ``table``; the D' store's sets or lengths) for global ids ``gids``, the
    same on every rank.  Exact (integer sums)."""
    if mesh.model <= 1:
        return table[gids.long()]
    flat = gids.reshape(-1)
    trail = tuple(table.shape[1:])
    # no location math: psum pays no alloc term
    ex = _resolve(mesh, flat.numel(), math.prod(trail), None, alloc_row=0.0)
    if ex.name == "psum":
        out = ex.set_lookup(table, flat, mesh)
    else:
        mine = ex.set_lookup(table, exl.chunk_for_rank(flat, mesh.rank,
                                                       mesh.model), mesh)
        out = col.all_gather(mine, mesh).reshape((-1,) + trail)
    return out.reshape(tuple(gids.shape) + trail)


@torch.no_grad()
def sharded_hashed_lookup(memory: torch.Tensor, gids: torch.Tensor, d: int,
                          m: int, seed: int, mesh: Mesh,
                          kind: str = "hashed_elem") -> SlabLookup:
    """The hashing trick with M sharded over 'model': gids [...] -> [...,
    d], bit-identical to ``lookup(M, alloc_hashed_*(gids))``."""
    flat = gids.reshape(-1).to(torch.int32)
    if mesh.model <= 1:
        alloc = (alc.alloc_hashed_elem if kind == "hashed_elem"
                 else alc.alloc_hashed_row)
        return _unsharded(memory, alloc(flat, d, m, seed), gids.shape)
    base, m_local = _slab(memory, mesh, m)
    ex = _resolve(mesh, flat.numel(), d, m)
    spec = fe.hashed_spec(kind, d, m, seed)
    if ex is exl.PSUM:
        out = col.psum(fe.fused_lookup(spec, memory, flat, base=base), mesh)
        return SlabLookup(
            out.reshape(*gids.shape, d),
            lambda: fe.fused_locations(spec, flat),
            lambda g: fe.fused_scatter_add(spec, g, flat, base=base,
                                           m_local=m_local), ex.name)
    out, loc = ex.lookup(memory, flat, d, mesh, _chunk_engine(spec, base))
    return _result(out, loc, base, m_local, ex.name, gids.shape)


@torch.no_grad()
def sharded_lma_lookup(memory: torch.Tensor, store_sets: torch.Tensor,
                       store_lengths: torch.Tensor, gids: torch.Tensor,
                       params: LMAParams, mesh: Mesh) -> SlabLookup:
    """LMA with M and the dense D' store both sharded over 'model' (this
    rank's pool slab and store rows): gids [...] -> [..., d], bit-identical
    to ``lookup(M, alloc_lma(params, store, gids))``.  Each batch row's D_v
    set is reconstructed through the strategy (integer sums, exact) before
    the location hashes run; under ring and all_to_all both run on 1/P of
    the batch per rank."""
    flat = gids.reshape(-1).to(torch.int32)
    if mesh.model <= 1:
        store = DenseSignatureStore(store_sets, store_lengths)
        return _unsharded(memory, alc.alloc_lma(params, store, flat),
                          gids.shape)
    base, m_local = _slab(memory, mesh, params.m)
    ex = _resolve(mesh, flat.numel(), params.d, params.m,
                  alloc_row=exl.alloc_bytes_per_row(
                      params.d, set_width=params.max_set))
    spec = fe.lma_spec(params)
    sets_l = store_sets[:, : params.max_set]
    if ex is exl.PSUM:
        rows = exl.local_gather_psum(sets_l, flat, mesh)       # exact
        support = exl.local_gather_psum(store_lengths, flat, mesh)
        part = fe.fused_lookup(spec, memory, flat, rows, support, base=base)
        return SlabLookup(
            col.psum(part, mesh).reshape(*gids.shape, params.d),
            lambda: fe.fused_locations(spec, flat, rows, support),
            lambda g: fe.fused_scatter_add(spec, g, flat, rows, support,
                                           base=base, m_local=m_local),
            ex.name)

    def inputs_fn(g):
        # the engine reconstructs sets through the owner-partial
        # all_to_all form whatever strategy carries the pool exchange, the
        # lengths riding as one more column of the set table: one gather
        # and one collective for the pair (integer sums: exact)
        packed = torch.cat([sets_l, store_lengths[:, None].to(sets_l.dtype)],
                           dim=1)
        rows, = exl.ALL_TO_ALL.set_lookup_many((packed,), g, mesh)
        return (rows[:, : params.max_set].contiguous(),
                rows[:, params.max_set].to(store_lengths.dtype).contiguous())

    out, loc = ex.lookup(memory, flat, params.d, mesh,
                         _chunk_engine(spec, base, inputs_fn))
    return _result(out, loc, base, m_local, ex.name, gids.shape)


# ------------------------------------------------------- sparse slab updates

def _slab_mask(idx: torch.Tensor, n_local: int, mesh: Mesh):
    """(local gather idx, drop-sentinel scatter idx, in-slab mask)."""
    rel = idx.long() - mesh.rank * n_local
    mine = (rel >= 0) & (rel < n_local)
    scat = torch.where(mine, rel, n_local).to(torch.int32)
    return torch.clamp(rel, 0, n_local - 1), scat, mine


def slab_aligned(unique: bool, buckets: int, k: int, n_model: int) -> bool:
    """True when a stripe-major bucketed stream's even [K] split lands each
    rank's slice exactly on its parameter slab: ``buckets = d`` stripes,
    ``d % P == 0``, so rank r's K/P chunk covers the whole stripes that
    tile its slab, duplicates included."""
    return (not unique and buckets > 0 and buckets % n_model == 0
            and k % n_model == 0)


def sharded_sparse_update(algo: str, indices, values, states: tuple,
                          hyper: dict, mesh: Mesh, *,
                          unique: bool = True, buckets: int = 0):
    """One sparse optimizer update on this rank's state slabs (``states``,
    viewed in the SparseGrad's layout: ``[m_local]`` or ``[rows_local,
    d]``), updated in place.

    ``indices [K]`` / ``values [K, ...]`` are the whole SparseGrad, the same
    on every rank.  Each rank masks it to its slab (off-slab entries to the
    local sentinel, values 0); duplicates of an owned slot are adjacent in
    the sorted stream, so the owner folds the whole run.  -> (indices, the
    update values, the states): the update is replicated under psum and
    owner-partial under all_to_all.  A slab-aligned stream is first cut to
    this rank's K/P slice, which needs no collective; the reference keeps
    that slice 'model'-sharded across devices, and a rank here returns the
    slice's indices with it."""
    from repro_torch.kernels.sparse_update.ops import sparse_update

    P = mesh.model
    aligned = slab_aligned(unique, buckets, int(indices.shape[0]), P)
    if aligned:
        indices = exl.chunk_for_rank(indices, mesh.rank, P)
        values = exl.chunk_for_rank(values, mesh.rank, P)
    _, scat, mine = _slab_mask(indices, int(states[0].shape[0]), mesh)
    vmask = mine.reshape(mine.shape + (1,) * (values.dim() - 1))
    lvals = torch.where(vmask, values, 0)
    u, new = sparse_update(algo, scat, lvals, tuple(states), unique=unique,
                           **hyper)
    if not aligned:
        u = exl.resolve_update_exchange(mesh).reduce_update(u, mesh)
    return indices, u, tuple(new)


def sharded_sparse_apply(param: torch.Tensor, indices, values,
                         mesh: Mesh) -> None:
    """The masked local scatter-add of SparseGrad update values into this
    rank's parameter slab (in place, in the SparseGrad's layout).  The mask
    makes it the right consumer for replicated (psum), owner-partial
    (all_to_all) and slab-sliced (aligned) updates alike."""
    _, scat, mine = _slab_mask(indices, int(param.shape[0]), mesh)
    param.index_add_(0, scat[mine].long(), values[mine].to(param.dtype))
