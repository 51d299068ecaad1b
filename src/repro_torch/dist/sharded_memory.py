"""Sharded common-memory lookups and sparse updates, on one rank (port of
``repro.dist.sharded_memory``).

The pool M ([m] floats) is sharded over the 'model' axis: rank r of P holds
the contiguous slab ``[r * m / P, (r + 1) * m / P)``, and for LMA the rows of
the D' store are sharded the same way (dense, or CSR re-based per rank by
``shard_csr_buffers``).  Each driver here is the body of the reference's
``shard_map``: it takes this rank's slab (and store rows) and this rank's
share of the batch's global ids, and runs the cross-rank traffic through an
:class:`~repro_torch.dist.exchange.Exchange` over the rank's 'model' group:

``psum``        the slab-mode lookup kernel over the rank's batch (LMA's
                set rows first reconstructed by psum), then one
                all-reduce;
``ring``        a chunk's locations and own-slab gather in one kernel, then
                the masked gather of each visiting chunk;
``all_to_all``  the chunk's locations kernel, one masked gather of the whole
                batch, one all-reduce.

All three are bit-identical to the single-device lookup.  The kernels run
on the card; for a pool on the CPU ``kernels/fused_embed/ops.py`` runs their
plain versions in the same places.  The strategy is the cost model's, or
the one ``REPRO_DIST_EXCHANGE`` (``exchange.FORCED``) pins, mapped through
the demotion ladder; an installed fault injector with a chunk fault wraps it
(``resilience.faults.wrap_exchange``).  A driver returns a
:class:`SlabLookup`: the output, the batch's locations (which the sparse
gradient records: the exchange assembled them anyway) and the slab's
gradient.  The backward differs from the reference's, which transposes the
collectives: every rank of a 'model' group holds the same cotangent of its
batch, so each scatters it into its own slab by the batch's locations, in
one launch and with no collective (the chunk scatter kernel, or for psum
the slab-mode scatter-add, which recomputes the locations).  That is the
batch's gradient restricted to the slab.

The 'data' axis: the batch's leading dimension is split over 'data' when D
divides it, else replicated (``_batch_axes``, the reference's rule).  The
reference's ``shard_map`` makes that split inside each driver; a rank of the
port is a process that holds only its share, so the split happens where the
batch enters the rank (``local_batch``, which the Trainer applies), and the
drivers see the share.  The 'model' exchanges then run within the rank's
'model' group on that share; the gradient's reduction over 'data' is the
Trainer's (``repro_torch.resilience.guard.make_step``).

``sharded_location_lookup`` is the generic lookup of any pure-location
scheme (freq): the scheme's locations on the split path, the gathers
through the slab-masked chunk kernels (rows 11 and 12).

The sparse update (``sharded_sparse_update`` / ``sharded_sparse_apply``):
each rank applies a masked local update to its own slab; off-slab entries
go to the sentinel ``n_local`` and are dropped.  A stripe-major bucketed
stream whose stripes tile the slabs (``slab_aligned``) gives each rank its
K/P slice, which holds every entry of its slab, and needs no collective.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
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


def _batch_axes(mesh, lead: int) -> tuple[str, ...]:
    """The dp axes the leading batch dim splits over: ('data',) when D > 1
    divides it, else () (replicated), as the reference's rule."""
    if mesh is not None and mesh.data > 1 and lead % mesh.data == 0:
        return ("data",)
    return ()


def local_batch(x, mesh):
    """This rank's share of ``x``'s leading batch dim, rows ``[d * B / D,
    (d + 1) * B / D)`` of data index d, when ``_batch_axes`` splits it;
    else ``x`` itself (numpy arrays and tensors alike)."""
    if not _batch_axes(mesh, int(x.shape[0])):
        return x
    c = int(x.shape[0]) // mesh.data
    return x[mesh.data_rank * c:(mesh.data_rank + 1) * c]


def _resolve(mesh, n_flat: int, d: int, m: int | None,
             alloc_row: float | None = None, fused: bool | None = None,
             fused_chunk: bool | None = None) -> exl.Exchange:
    """``REPRO_DIST_EXCHANGE`` > cost model (both through the demotion
    ladder), with psum where the chosen strategy cannot split the batch.
    Given ``m``, a fused flag left None comes from its gate, which every
    slab ``_slab`` accepts passes.  An installed injector with an armed
    chunk fault wraps a chunked strategy (``faults.wrap_exchange``)."""
    from repro_torch.resilience import faults as flt
    ex = exl.resolve_exchange(mesh, B=n_flat, d=d, m=m, alloc_row=alloc_row,
                              fused=fused, fused_chunk=fused_chunk)
    if not ex.eligible(n_flat, mesh.model):
        ex = exl.PSUM
    return flt.wrap_exchange(ex)


def _chunk_engine(spec, base: int, inputs_fn=None,
                  loc_fn=None) -> exl.FusedChunkEngine:
    """The chunked strategies' engine: the chunk's location math runs in
    the kernels of ``spec`` (the scheme's FusedSpec), ``inputs_fn(g) ->
    (sets, support)`` supplying its inputs (LMA's set reconstruction, a
    uniform collective).  ``spec=None`` is the generic form: ``loc_fn(g)``
    computes the locations on the split path, and only the slab-masked
    gather runs in a kernel (row 11)."""
    def gather(mem_l, loc):
        return fe.fused_chunk_gather(mem_l, loc, base)

    if spec is None:
        def generic_lookup(mem_l, g):
            loc = loc_fn(g)
            return gather(mem_l, loc), loc

        return exl.FusedChunkEngine(generic_lookup, loc_fn, gather)

    def inputs(g):
        return inputs_fn(g) if inputs_fn is not None else (None, None)

    def chunk_lookup(mem_l, g):
        return fe.fused_chunk_lookup(spec, mem_l, g, *inputs(g), base=base)

    def locations(g):
        return fe.fused_locations(spec, g, *inputs(g))

    return exl.FusedChunkEngine(chunk_lookup, locations, gather)


@torch.no_grad()
def sharded_location_lookup(memory: torch.Tensor, gids: torch.Tensor,
                            loc_fn: Callable, d: int, m: int,
                            mesh: Mesh) -> SlabLookup:
    """The generic sharded lookup of any pure-location scheme: gids [...]
    -> [..., d], bit-identical to ``lookup(M, loc_fn(gids))`` under every
    strategy.  ``loc_fn``: [n] global ids -> [n, d] int32 locations into
    the [m] pool, communication-free (the chunked strategies call it on a
    rank's chunk).  psum: the locations of the rank's batch and one
    slab-masked gather, all-reduced; ring and all_to_all: the chunk
    engine's generic form.  No fused discount is priced (the location
    math stays on the split path), as in the reference."""
    flat = gids.reshape(-1).to(torch.int32)
    if mesh.model <= 1:
        return _unsharded(memory, loc_fn(flat), gids.shape)
    base, m_local = _slab(memory, mesh, m)
    ex = _resolve(mesh, flat.numel(), d, m,
                  alloc_row=exl.alloc_bytes_per_row(d), fused=False,
                  fused_chunk=False)
    engine = _chunk_engine(None, base, loc_fn=loc_fn)
    if ex is exl.PSUM:
        loc = loc_fn(flat)
        out = col.psum(engine.gather(memory, loc), mesh)
    else:
        out, loc = ex.lookup(memory, flat, d, mesh, engine)
    return _result(out, loc, base, m_local, ex.name, gids.shape)


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


# ------------------------------------------------------ sharded CSR store
#
# The CSR form (store_flat [nnz] / store_offsets [n+1]) cannot shard by an
# even row split of its arrays: offsets index the global flat array.
# ``shard_csr`` re-bases once, on the host, at buffer build: each rank's
# rows become a local CSR over its own slice of flat.  The set rows are then
# assembled across ranks by ``Exchange.partial_sum_lookup`` as the dense
# ``set_lookup`` does: the owning rank gives the real elements, every other
# rank exact zeros, and the integer sum is exact under all three
# strategies.  Sample ids are int32 bit patterns, as everywhere in the port.


def shard_csr(flat, offsets, n_model: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: a global CSR -> every rank's re-based CSR, stacked:
    (flat_sh [n_model, cap] zero-padded to the largest rank's nnz (at least
    1), offs_sh [n_model, c + 1] int32), c = rows / n_model.  The
    reference's function, on numpy arrays."""
    flat = np.asarray(flat)
    offsets = np.asarray(offsets, np.int64)
    n = int(offsets.shape[0]) - 1
    if n % n_model:
        raise ValueError(f"{n} store rows do not divide over {n_model} "
                         "ranks")
    c = n // n_model
    bounds = [(int(offsets[r * c]), int(offsets[(r + 1) * c]))
              for r in range(n_model)]
    cap = max(max(e - s for s, e in bounds), 1)
    flat_sh = np.zeros((n_model, cap), flat.dtype)
    offs_sh = np.zeros((n_model, c + 1), np.int32)
    for r, (s, e) in enumerate(bounds):
        flat_sh[r, : e - s] = flat[s:e]
        offs_sh[r] = (offsets[r * c: (r + 1) * c + 1] - s).astype(np.int32)
    return flat_sh, offs_sh


def _csr_part(flat: torch.Tensor, offsets: torch.Tensor, rank: int,
              n_model: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank ``rank``'s row of ``shard_csr``, on the arrays' device, cut
    from the global CSR without the padding (masked positions are never
    read)."""
    c = (int(offsets.shape[0]) - 1) // n_model
    lo, hi = int(offsets[rank * c]), int(offsets[(rank + 1) * c])
    part = flat[lo:hi].clone() if hi > lo else torch.zeros(
        1, dtype=flat.dtype, device=flat.device)
    offs = (offsets[rank * c:(rank + 1) * c + 1] - lo).to(torch.int32)
    return part, offs


def shard_csr_buffers(buffers: dict, mesh) -> dict:
    """Raw CSR store buffers -> this rank's 'model'-sharded form
    (``store_flat_sh``, ``store_offsets_sh``, its ``store_lengths`` rows)
    when a 'model' axis of more than one rank divides the rows; otherwise
    the buffers as they are (the store then stays whole on every rank and
    the lookup takes the generic path)."""
    P = mesh.model if mesh is not None else 1
    if "store_flat" not in buffers or P <= 1:
        return buffers
    n = int(buffers["store_offsets"].shape[0]) - 1
    if n % P:
        return buffers
    flat, offs = _csr_part(buffers["store_flat"], buffers["store_offsets"],
                           mesh.rank, P)
    lengths = buffers["store_lengths"]
    c = n // P
    out = {k: v for k, v in buffers.items()
           if k not in ("store_flat", "store_offsets", "store_lengths")}
    out["store_flat_sh"] = flat
    out["store_offsets_sh"] = offs
    out["store_lengths"] = lengths[mesh.rank * c:(mesh.rank + 1) * c].clone()
    return out


def _csr_local_sets(flat_l, offs_l, v, max_len: int, mesh: Mesh):
    """This rank's part of the ragged-set gather for global rows ``v``
    [B]: (elems [B, max_len] int32, length [B] int32), the real values on
    owned rows and exact zeros elsewhere: the ``local_fn`` contract of
    ``Exchange.partial_sum_lookup``."""
    c = int(offs_l.shape[0]) - 1
    rel = v.long() - mesh.rank * c
    mine = (rel >= 0) & (rel < c)
    safe = torch.clamp(rel, 0, c - 1)
    start = offs_l[safe].long()
    length = offs_l[safe + 1].long() - start
    pos = torch.arange(max_len, device=v.device)[None, :]
    mask = (pos < torch.clamp(length, max=max_len)[:, None]) & mine[:, None]
    idx = torch.clamp(start[:, None] + pos, 0, flat_l.shape[0] - 1)
    elems = flat_l[idx].to(torch.int32)
    return (torch.where(mask, elems, 0),
            torch.where(mine, length, 0).to(torch.int32))


def _csr_rows(ex: exl.Exchange, flat_l, offs_l, len_l, g, max_len: int,
              mesh: Mesh):
    """(elems, length, support) of rows ``g`` through ``ex``'s
    ``partial_sum_lookup`` (exact: integer sums of one owner's values)."""
    def local_fn(q):
        elems, ln = _csr_local_sets(flat_l, offs_l, q, max_len, mesh)
        return elems, ln, exl.local_gather(len_l, q, mesh)

    return ex.partial_sum_lookup(local_fn, g, mesh)


def _set_mask(ln: torch.Tensor, max_len: int) -> torch.Tensor:
    pos = torch.arange(max_len, device=ln.device)[None, :]
    return pos < torch.clamp(ln, max=max_len)[:, None]


@torch.no_grad()
def sharded_csr_set_lookup(flat_l, offs_l, lengths, value_ids,
                           max_len: int, mesh: Mesh):
    """D_v rows from the 'model'-sharded CSR store (this rank's
    ``store_flat_sh``, ``store_offsets_sh`` and ``store_lengths``): value
    ids [...] -> (elems [..., max_len] int32, zero past each set's end;
    mask; support [...]), bit-identical to ``gather_ragged_sets`` and a
    masked fill on the whole store.  Exact under every strategy."""
    if mesh.model <= 1:
        raise ValueError("sharded_csr_set_lookup needs a 'model' axis of "
                         "more than one rank")
    flat = value_ids.reshape(-1)
    ex = _resolve(mesh, flat.numel(), max_len, None, alloc_row=0.0)
    if ex.name == "psum":
        elems, ln, sup = _csr_rows(ex, flat_l, offs_l, lengths, flat,
                                   max_len, mesh)
    else:
        chunk = exl.chunk_for_rank(flat, mesh.rank, mesh.model)
        e_c, l_c, s_c = _csr_rows(ex, flat_l, offs_l, lengths, chunk,
                                  max_len, mesh)
        elems = col.all_gather(e_c, mesh).reshape(-1, max_len)
        ln = col.all_gather(l_c, mesh).reshape(-1)
        sup = col.all_gather(s_c, mesh).reshape(-1)
    shape = tuple(value_ids.shape)
    return (elems.reshape(shape + (max_len,)),
            _set_mask(ln, max_len).reshape(shape + (max_len,)),
            sup.reshape(shape))


@torch.no_grad()
def sharded_lma_lookup_csr(memory: torch.Tensor, flat_l, offs_l,
                           store_lengths, gids: torch.Tensor,
                           params: LMAParams, mesh: Mesh) -> SlabLookup:
    """LMA with M and the CSR D' store both sharded over 'model' (this
    rank's pool slab and CSR part): gids [...] -> [..., d], bit-identical to
    ``lookup(M, alloc_lma(params, SignatureStore(...), gids))``.  The
    ragged sets are reconstructed by ``partial_sum_lookup`` (PAD where a
    set ends), then the dense driver's kernels run on them: psum's
    slab-mode lookup over the rank's batch, or the chunk engine, whose set
    reconstruction is all_to_all's whatever strategy carries the pool
    exchange (as the dense store's)."""
    if mesh.model <= 1:
        raise ValueError("sharded_lma_lookup_csr needs a 'model' axis of "
                         "more than one rank")
    flat = gids.reshape(-1).to(torch.int32)
    base, m_local = _slab(memory, mesh, params.m)
    ex = _resolve(mesh, flat.numel(), params.d, params.m,
                  alloc_row=exl.alloc_bytes_per_row(
                      params.d, set_width=params.max_set),
                  fused=False, fused_chunk=True)
    spec = fe.lma_spec(params)

    def inputs(set_ex, g):
        elems, ln, sup = _csr_rows(set_ex, flat_l, offs_l, store_lengths, g,
                                   params.max_set, mesh)
        rows = torch.where(_set_mask(ln, params.max_set), elems, -1)
        return rows.contiguous(), sup.to(store_lengths.dtype).contiguous()

    if ex is exl.PSUM:
        rows, support = inputs(ex, flat)
        part = fe.fused_lookup(spec, memory, flat, rows, support, base=base)
        return SlabLookup(
            col.psum(part, mesh).reshape(*gids.shape, params.d),
            lambda: fe.fused_locations(spec, flat, rows, support),
            lambda g: fe.fused_scatter_add(spec, g, flat, rows, support,
                                           base=base, m_local=m_local),
            ex.name)
    out, loc = ex.lookup(memory, flat, params.d, mesh,
                         _chunk_engine(spec, base,
                                       lambda g: inputs(exl.ALL_TO_ALL, g)))
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
