"""Cross-rank exchange strategies for the sharded memory pool (port of
``repro.dist.exchange``).

Every collective of the sharded common-memory path (the lookup's assembly,
the D' set reconstruction and the sparse update) goes through one of three
strategies:

``psum``
    Every rank computes locations for the whole batch, gathers the slots in
    its own slab (exact 0 elsewhere), and one all-reduce assembles the
    result.  The bit-exact oracle.
``ring``
    Each rank computes locations once for its 1/P chunk of the batch; the
    (accumulator, locations) pair then visits every slab around the ring,
    each rank adding its slab's part.
``all_to_all``
    Chunked locations are all-gathered, every rank gathers its slab's part
    for the whole batch, and an all_to_all hands each rank the parts of its
    chunk (a reduce-scatter), followed by one all-gather.  Its sparse update
    needs no collective at all.

All three give bit-identical lookups: exactly one rank owns each slot, so a
cross-rank sum adds exact zeros (x + 0.0 is x, up to the sign of a zero).

Differences from the reference, which runs these inside a ``shard_map`` on
global arrays:

- Each rank is a process: functions take the rank's local slab and a
  :class:`~repro_torch.dist.context.Mesh` (its rank and 'model' group) in
  place of an axis name, and the collectives are
  ``repro_torch.dist.collectives``.
- ``Exchange.lookup`` (ring, all_to_all) always runs the
  :class:`FusedChunkEngine` and returns the whole batch's ``[n, d]``
  locations beside the values (the ring's visiting chunks, all_to_all's
  gathered ones): the port's backward and its sparse gradient read them
  instead of transposing the collectives.  psum's lookup is the drivers'
  whole-batch slab lookup (``repro_torch.dist.sharded_memory``).
- ``fused_slab_eligible`` / ``fused_chunk_eligible``: the CUDA kernels read
  the slab from device memory, so there is no VMEM gate; a pool is
  eligible whenever P divides m.  That holds for every slab
  (``sharded_memory`` refuses any other), so the kernel paths are the only
  ones, on the CPU too, where ``kernels/fused_embed/ops.py`` sends a CPU
  tensor to the kernels' plain versions.
- The demotion ladder (``demote``, ``effective``) is the reference's; the
  fault wrapper that drives it is ``repro_torch.resilience.faults.
  FaultyExchange`` and the guard that demotes is ``repro_torch.resilience.
  exchange_guard``.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, ClassVar

import torch

from repro_torch.dist import collectives as col
from repro_torch.dist.context import Mesh

# Forced strategy: "psum" | "ring" | "all_to_all"; None/"auto" -> cost model.
_env = os.environ.get("REPRO_DIST_EXCHANGE", "auto").strip().lower()
FORCED: str | None = None if _env in ("", "auto") else _env


def model_size(mesh) -> int:
    return int(dict(mesh.shape).get("model", 1))


# --------------------------------------------------------- slab primitives

def local_gather(shard: torch.Tensor, idx: torch.Tensor,
                 mesh: Mesh) -> torch.Tensor:
    """Gather the global indices ``idx`` that land in this rank's axis-0
    slab ``shard``, exact 0 elsewhere."""
    n_local = shard.shape[0]
    rel = idx.long() - mesh.rank * n_local
    mine = (rel >= 0) & (rel < n_local)
    vals = shard[torch.clamp(rel, 0, n_local - 1)]
    mask = mine.reshape(mine.shape + (1,) * (vals.dim() - mine.dim()))
    return torch.where(mask, vals, torch.zeros((), dtype=vals.dtype,
                                               device=vals.device))


def local_gather_psum(shard: torch.Tensor, idx: torch.Tensor,
                      mesh: Mesh) -> torch.Tensor:
    """Row-sharded table + the same global indices on every rank -> the
    full rows (exactly one rank owns each, so the sum is exact)."""
    return col.psum(local_gather(shard, idx, mesh), mesh)


def chunk_for_rank(x: torch.Tensor, rank: int, n_model: int) -> torch.Tensor:
    """This rank's contiguous 1/n_model slice of the leading axis."""
    c = x.shape[0] // n_model
    return x[rank * c:(rank + 1) * c]


def _sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 in the input's own type (torch promotes ints)."""
    return torch.sum(x, dim=0, dtype=x.dtype)


# ----------------------------------------------------- fused chunked engine

@dataclasses.dataclass(frozen=True)
class FusedChunkEngine:
    """The chunked strategies' kernel engine (``repro_torch/dist/
    sharded_memory.py`` builds it per scheme).

    ``chunk_lookup(mem_l, g_chunk) -> (partial [c, d], loc [c, d])``
        The ring's step 0: the chunk's locations and this rank's masked
        gather of them in one kernel (may run uniform collectives first:
        LMA's set reconstruction).
    ``locations(g_chunk) -> loc [c, d]``
        all_to_all's form of the chunk's location math.
    ``gather(mem_l, loc) -> partial``
        The masked gather by given locations (ring steps 1..P-1, and
        all_to_all's whole-batch partial), bit-identical to
        :func:`local_gather`.
    """

    chunk_lookup: Callable
    locations: Callable
    gather: Callable


# -------------------------------------------------------------- strategies

class Exchange:
    """One cross-rank exchange policy.

    ``lookup(mem_l, gids, d, mesh, engine)`` (chunked strategies)
        [n] global ids (the same on every rank) -> ([n, d] values, the same
        on every rank; [n, d] int32 global locations of the whole batch),
        through the :class:`FusedChunkEngine` on this rank's chunk, so a
        collective inside the engine must be uniform in chunk length.
    ``set_lookup(shard, idx, mesh)`` / ``set_lookup_many(shards, idx, mesh)``
        Row-sharded table(s) + per-rank indices -> the complete rows for
        those indices (exact for integers); chunked strategies accept a
        different ``idx`` on every rank.
    ``partial_sum_lookup(local_fn, idx, mesh)``
        The sum over ranks of ``local_fn(idx)``, each rank contributing its
        owned part and exact zeros elsewhere.
    ``reduce_update(u, mesh)``
        The sparse update's exchange: owner-masked update values -> what
        ``sharded_sparse_apply`` consumes.
    """

    name: ClassVar[str]

    def eligible(self, n_flat: int, n_model: int) -> bool:
        """Can this strategy run a lookup of ``n_flat`` rows?"""
        return True

    def lookup(self, mem_l, gids, d: int, mesh: Mesh,
               engine: FusedChunkEngine):
        raise NotImplementedError

    def set_lookup(self, shard, idx, mesh: Mesh) -> torch.Tensor:
        return self.set_lookup_many((shard,), idx, mesh)[0]

    def set_lookup_many(self, shards: tuple, idx, mesh: Mesh) -> tuple:
        raise NotImplementedError

    def partial_sum_lookup(self, local_fn, idx, mesh: Mesh) -> tuple:
        raise NotImplementedError

    def reduce_update(self, u, mesh: Mesh) -> torch.Tensor:
        return col.psum(u, mesh)


class PsumExchange(Exchange):
    """Mask-local-gather + one all-reduce (the bit-exact oracle)."""

    name = "psum"

    def set_lookup_many(self, shards, idx, mesh):
        # idx is the same on every rank (psum's lookup sees the whole
        # batch)
        return tuple(local_gather_psum(s, idx, mesh) for s in shards)

    def partial_sum_lookup(self, local_fn, idx, mesh):
        return tuple(col.psum(p, mesh) for p in local_fn(idx))


class RingExchange(Exchange):
    """Batch chunks ppermute'd around the 'model' ring: each chunk's
    (locations, accumulator) pair visits every slab once; location math runs
    once per chunk, 1/P of psum's."""

    name = "ring"

    def eligible(self, n_flat, n_model):
        return n_model > 1 and n_flat % n_model == 0

    def _ring(self, shards, idx, accs, mesh):
        """One traversal: ``idx`` and every accumulator ride together, each
        rank adding its slab's part per step.  -> (the accumulators, back
        home; the idx chunks this rank saw, in chunk order)."""
        P, r = mesh.model, mesh.rank
        seen = [None] * P
        for t in range(P):
            seen[(r - t) % P] = idx
            accs = tuple(a + local_gather(s, idx, mesh)
                         for s, a in zip(shards, accs))
            if t < P - 1:
                idx = col.ppermute(idx, mesh)
                accs = tuple(col.ppermute(a, mesh) for a in accs)
        # after the last gather the chunk sits one hop short of home
        return tuple(col.ppermute(a, mesh) for a in accs), seen

    def lookup(self, mem_l, gids, d, mesh, engine):
        P, r = mesh.model, mesh.rank
        chunk = chunk_for_rank(gids, r, P)
        # step 0 is one kernel (location math + own-slab gather, locations
        # emitted); steps 1..P-1 gather each visiting chunk by its
        # circulated locations.  The accumulation order is the reference's
        # (_ring's), so the result stays bitwise identical (partial-first
        # against zeros-plus-partial differs only on -0.0, which the other
        # ranks' +0.0 contributions erase).
        acc, loc = engine.chunk_lookup(mem_l, chunk)
        seen = [None] * P
        seen[r] = loc
        # the (acc, loc) pair rides each hop as ONE packed int32 buffer,
        # the accumulator's bits reinterpreted: a ppermute moves data only,
        # so the round trip is exact
        pack = acc.dtype.itemsize == 4 and acc.dim() == loc.dim()
        d_acc = acc.shape[-1]
        for t in range(1, P):
            if pack:
                buf = torch.cat([acc.contiguous().view(torch.int32), loc],
                                dim=-1)
                buf = col.ppermute(buf, mesh)
                acc = buf[..., :d_acc].contiguous().view(acc.dtype)
                loc = buf[..., d_acc:].contiguous()
            else:
                loc = col.ppermute(loc, mesh)
                acc = col.ppermute(acc, mesh)
            seen[(r - t) % P] = loc
            acc = acc + engine.gather(mem_l, loc)
        # no homing hop: rank r finishes chunk r+1, so the all-gather comes
        # out rotated by one, and a local roll re-homes it
        out = torch.roll(col.all_gather(acc, mesh), 1, dims=0)
        return out.reshape(-1, d), torch.cat(seen)

    def set_lookup_many(self, shards, idx, mesh):
        accs = tuple(torch.zeros(idx.shape + s.shape[1:], dtype=s.dtype,
                                 device=s.device) for s in shards)
        return self._ring(shards, idx, accs, mesh)[0]

    def partial_sum_lookup(self, local_fn, idx, mesh):
        # _ring's traversal with the first application seeding the
        # accumulators
        P = mesh.model
        accs = None
        for t in range(P):
            part = tuple(local_fn(idx))
            accs = part if accs is None else tuple(
                a + p for a, p in zip(accs, part))
            if t < P - 1:
                idx = col.ppermute(idx, mesh)
                accs = tuple(col.ppermute(a, mesh) for a in accs)
        return tuple(col.ppermute(a, mesh) for a in accs)


class AllToAllExchange(Exchange):
    """Owner-sliced exchanges: a reduce-scatter spelled as all_to_all + sum.

    Lookup: chunked locations are all-gathered, each rank contributes its
    slab's part for the whole batch, the all_to_all hands every rank the
    parts of its chunk, and one all-gather replicates the finished chunks.
    Update: no collective; each rank's values are exact at its own slots,
    which is all the masked apply reads."""

    name = "all_to_all"

    def eligible(self, n_flat, n_model):
        return n_model > 1 and n_flat % n_model == 0

    def lookup(self, mem_l, gids, d, mesh, engine):
        chunk = chunk_for_rank(gids, mesh.rank, mesh.model)
        # the chunk's locations by the kernel, one masked gather for the
        # whole batch, and ONE all-reduce of the parts (the reference's
        # reduce-scatter as all_to_all + sum, then all-gather)
        loc = engine.locations(chunk)                        # [c, d]
        full = col.all_gather(loc, mesh).reshape(-1, d)      # in order
        return col.psum(engine.gather(mem_l, full), mesh), full

    def set_lookup_many(self, shards, idx, mesh):
        P = mesh.model
        full = col.all_gather(idx, mesh).reshape(-1)       # one round
        outs = []
        for s in shards:
            part = local_gather(s, full, mesh)
            part = part.reshape((P,) + tuple(idx.shape) + tuple(s.shape[1:]))
            outs.append(_sum0(col.all_to_all(part, mesh)))
        return tuple(outs)

    def partial_sum_lookup(self, local_fn, idx, mesh):
        P = mesh.model
        flat = col.all_gather(idx, mesh).reshape((-1,) + tuple(idx.shape[1:]))
        outs = []
        for part in tuple(local_fn(flat)):
            part = part.reshape((P, idx.shape[0]) + tuple(part.shape[1:]))
            outs.append(_sum0(col.all_to_all(part, mesh)))
        return tuple(outs)

    def reduce_update(self, u, mesh):
        # owner-partial: each rank keeps its owned slices; valid only for
        # the masked apply (sharded_sparse_apply)
        return u


PSUM = PsumExchange()
RING = RingExchange()
ALL_TO_ALL = AllToAllExchange()
_STRATEGIES = {e.name: e for e in (PSUM, RING, ALL_TO_ALL)}


def get_exchange(name: str) -> Exchange:
    if name not in _STRATEGIES:
        raise KeyError(f"unknown exchange strategy {name!r}; "
                       f"known: {sorted(_STRATEGIES)}")
    return _STRATEGIES[name]


def list_exchanges() -> list[str]:
    return sorted(_STRATEGIES)


# --------------------------------------------------------- demotion ladder
#
# When a chunked strategy fails validation (``repro_torch.resilience.
# exchange_guard``: an injected chunk drop or corruption, or any shape,
# finiteness or bitwise mismatch against the psum oracle), it is demoted
# for the rest of the process and the resolvers stop picking it.  The chain
# is all_to_all -> ring -> psum; psum, the bit-exact oracle, is terminal.
# FORCED and the cost model honour it.

FALLBACK = {"all_to_all": "ring", "ring": "psum", "psum": None}
DEMOTED: dict[str, str] = {}   # name -> reason it was demoted


def demote(name: str, reason: str = "validation failure") -> str:
    """Demote ``name`` for the rest of the run; -> its effective successor."""
    if name not in _STRATEGIES:
        raise KeyError(f"unknown exchange strategy {name!r}")
    if name == "psum":
        raise ValueError("psum is the terminal bit-exact oracle; "
                         "there is nothing to demote it to")
    DEMOTED[name] = reason
    return effective(FALLBACK[name])


def effective(name: str) -> str:
    """Map a requested strategy through the demotion chain."""
    while name in DEMOTED and FALLBACK.get(name):
        name = FALLBACK[name]
    return name


def reset_demotions():
    DEMOTED.clear()


# -------------------------------------------------------------- cost model
#
# Modeled per-device bytes, as in the reference (constants and formulas
# copied): collective terms count the bytes a device sends (a ring
# all-reduce ~ 2(P-1)/P x buffer); allocation terms count the write and read
# of the [rows, d] int32 location tensor plus any per-row exchange the
# allocator needs (LMA's set reconstruction).

def fused_slab_eligible(m: int, n_model: int, itemsize: int = 4) -> bool:
    """Can psum run the slab-mode lookup kernel on a ``[m / n_model]``
    slab?  The reference gates on the slab fitting the TPU's VMEM; the
    CUDA kernel reads the slab from device memory, so here any whole slab
    qualifies (P divides m).  ``itemsize`` is kept for signature parity."""
    return m % max(n_model, 1) == 0


def fused_chunk_eligible(m: int, n_model: int, itemsize: int = 4) -> bool:
    """Can ring / all_to_all run the chunk engine's kernels on the slab?
    The reference asks for a VMEM-sized slab block; here, as for
    :func:`fused_slab_eligible`, any whole slab of a 'model' axis."""
    return n_model > 1 and m % n_model == 0


def alloc_bytes_per_row(d: int, set_width: int = 0):
    """Location-math bytes for one batch row on the split path: the [d]
    int32 location row's round trip plus the set-row exchange of a
    set-based allocator (LMA)."""
    return 8 * d + 8 * set_width


RING_OVERLAP = 0.5   # fraction of ring step transfers hidden behind gathers


def tier_fetch_bytes(n_cold_blocks: int, block: int, n_leaves: int = 1,
                     itemsize: int = 4) -> int:
    """Modeled host<->device bytes per step of a tiered pool
    (``repro_torch.tier``): each cold block a step touches crosses twice --
    the staged fetch down and the post-update write-back up -- for every
    pool leaf (values and optimizer moments)."""
    return 2 * n_cold_blocks * block * itemsize * n_leaves


def lookup_cost(n_model: int, n: int, d: int,
                alloc_row: float | None = None,
                fused: bool = False,
                fused_chunk: bool = False) -> dict[str, float]:
    """Per-device modeled bytes of one sharded lookup of ``n`` flat rows.

    psum: location math for all n rows, one [n, d] all-reduce.  ring:
    location math on n/P rows, (P-1) neighbour transfers of the chunk pair
    charged at ``RING_OVERLAP``, plus the homing permute and all-gather.
    all_to_all: location math on n/P rows, all-gather of locations,
    all_to_all of partials, all-gather of outputs.  ``fused`` discounts
    psum's location round trip, ``fused_chunk`` ring's and all_to_all's;
    the set-reconstruction exchange survives every discount."""
    P = max(n_model, 1)
    base = 8 * d if alloc_row is None else alloc_row
    a = (max(base - 8 * d, 0) if fused_chunk else base) * n
    a_psum = (max(base - 8 * d, 0) if fused else base) * n
    row = 4 * d * n                    # one [n, d] f32 / int32 pass
    frac = (P - 1) / P
    return {
        "psum": a_psum + 2 * frac * row,
        "ring": a / P + RING_OVERLAP * 2 * frac * row + frac * row + row / P,
        "all_to_all": a / P + 3 * frac * row,
    }


def resolve_exchange(mesh, B: int | None = None, d: int | None = None,
                     m: int | None = None, K: int | None = None,
                     alloc_row: float | None = None,
                     fused: bool | None = None,
                     fused_chunk: bool | None = None) -> Exchange:
    """Pick the strategy for a lookup of ``B`` flat rows per rank.

    ``REPRO_DIST_EXCHANGE`` (``FORCED``) short-circuits the model; unknown
    shapes or a batch P does not divide give psum.  Each fused flag is
    clamped through its own gate, and derived from ``m`` through it when
    not given.  ``K`` is accepted for signature parity; lookups ignore
    it."""
    n_model = model_size(mesh) if mesh is not None else 1
    if n_model <= 1:
        return PSUM
    if FORCED is not None:
        return get_exchange(effective(FORCED))
    if B is None or d is None or B % n_model != 0:
        return PSUM
    if fused is None:
        fused = m is not None and fused_slab_eligible(m, n_model)
    elif fused and m is not None:
        fused = fused_slab_eligible(m, n_model)
    if fused_chunk is None:
        fused_chunk = m is not None and fused_chunk_eligible(m, n_model)
    elif fused_chunk and m is not None:
        fused_chunk = fused_chunk_eligible(m, n_model)
    costs = lookup_cost(n_model, B, d, alloc_row, fused=fused,
                        fused_chunk=fused_chunk)
    live = {n: c for n, c in costs.items() if n not in DEMOTED}
    name = min(live, key=live.get)
    ex = _STRATEGIES[name]
    return ex if ex.eligible(B, n_model) else PSUM


# ------------------------------------------------- sparse-update gate
#
# The reference's model of one pool step's bytes, sparse against dense
# (constants and formulas copied): the SparseGrad's construction (a flat
# O(K log K) sort, or d per-stripe sorts at BUCKETED_SORT_SPEEDUP the byte
# efficiency), its exchange (replicated under psum, owner slices under
# all_to_all) and the dense slab's O(m / P) passes.  The port's Trainer
# does not consult it (its sparse gate is REPRO_SPARSE_GRADS); a gate priced
# from the card's own measurements is ROADMAP.md's, Queue 2.

SORT_BYTES_PER_KEY_PASS = 4.0      # one 4-byte key pass per merge level
BUCKETED_SORT_SPEEDUP = 5.0


def dedup_sort_bytes(k: int, buckets: int = 0) -> float:
    """Modeled bytes of building one sorted SparseGrad from ``k``
    locations: flat, k keys x log2 k merge passes; bucketed (``buckets ==
    d``), d per-stripe sorts of k / d keys at ``BUCKETED_SORT_SPEEDUP``."""
    if k <= 1:
        return 0.0
    if buckets and k % buckets == 0 and k > buckets:
        return (SORT_BYTES_PER_KEY_PASS * k * math.log2(k // buckets)
                / BUCKETED_SORT_SPEEDUP)
    return SORT_BYTES_PER_KEY_PASS * k * math.log2(k)


def sparse_update_cost(n_model: int, n_lookups: int, d: int, m: int,
                       row_mode: bool = False,
                       buckets: int = 0) -> dict[str, float]:
    """Per-device modeled bytes of one memory-pool optimizer step:
    ``dense`` (~8 f32 passes over the slab), ``sparse_psum`` (the
    replicated pair, its broadcast and the update psum, plus the sort),
    ``sparse_all_to_all`` (owned slices; flat records route through the
    index vector once, bucketed ones shard the sort when 'model' divides
    the buckets) and ``dedup_sort``, the sort term all_to_all was
    charged."""
    P = max(n_model, 1)
    k_elems = n_lookups * d
    k_idx = n_lookups if row_mode else k_elems
    idx_b, val_b = 4 * k_idx, 4 * k_elems
    sort = dedup_sort_bytes(k_idx, buckets)
    shard = P if (buckets and buckets % P == 0) else 1
    if buckets:
        a2a = (idx_b + val_b) / P + sort / shard
    else:
        a2a = (idx_b + val_b) / P + idx_b + sort
    return {
        "dense": 8 * (m // P) * 4,
        "sparse_psum": 2 * (idx_b + val_b) + sort,
        "sparse_all_to_all": a2a,
        "dedup_sort": sort / shard,
    }


def sparse_worthwhile(mesh, n_lookups: int, d: int, m: int,
                      row_mode: bool = False, buckets: int = 0) -> bool:
    """Does the best sparse exchange (psum, or all_to_all under a 'model'
    axis unless psum or ring is forced) model cheaper than the dense slab
    update?"""
    n_model = model_size(mesh) if mesh is not None else 1
    costs = sparse_update_cost(n_model, n_lookups, d, m, row_mode, buckets)
    # ring forces fall back to psum for the update exchange
    # (resolve_update_exchange), so they are priced as psum here too
    best = costs["sparse_psum"] if (n_model <= 1
                                    or FORCED in ("psum", "ring")) \
        else min(costs["sparse_psum"], costs["sparse_all_to_all"])
    return best < costs["dense"]


def resolve_update_exchange(mesh) -> Exchange:
    """The sparse update's strategy: all_to_all whenever a 'model' axis
    exists (its update exchange is free); a ring force falls back to psum
    (ring has no update form), and so does a demoted all_to_all (its
    update form has no ring rung)."""
    n_model = model_size(mesh) if mesh is not None else 1
    if n_model <= 1:
        return PSUM
    if FORCED is not None:
        ex = get_exchange(effective(FORCED))
        return PSUM if ex is RING else ex
    return PSUM if "all_to_all" in DEMOTED else ALL_TO_ALL
