"""Plain PyTorch versions of the fused engine: the split path it replaces.

Locations materialized by the allocators, then a gather (and for bags the
weighted reduce); backward, the scatter-add by ``index_add_`` and the bag
weight gradient by gather and sum.  The kernels are bit-identical to
``locations_ref`` and ``fused_lookup_ref``, and within float32 summation
order of the bag, the scatter-add and the weight gradient.

Slab mode: ``memory`` may be one rank's ``[m_local]`` slab of a pool sharded
over the 'model' axis, ``base`` its first global slot.  A location outside
``[base, base + m_local)`` gathers an exact 0 and scatters nothing: the
mask-local-gather of ``repro_torch/dist/exchange.py``.  With ``base = 0``
and the whole pool the mask is all true.  The chunked exchange's three
(``chunk_lookup_ref``, ``chunk_gather_ref``, ``chunk_scatter_ref``) take and
give the ``[N, d]`` global locations themselves.
"""
from __future__ import annotations

import torch

from repro_torch.core import allocation as alc
from repro_torch.core.memory import lookup


def _lma_params(spec) -> alc.LMAParams:
    return alc.LMAParams(d=spec.d, m=spec.m, n_h=spec.n_h, seed=spec.seed,
                         max_set=spec.max_set, min_support=spec.min_support,
                         independent_hashes=spec.independent,
                         striped=spec.striped)


def locations_ref(spec, gids, sets=None, support=None) -> torch.Tensor:
    """[N] ids (+ lma set rows and support) -> [N, d] int32 locations."""
    if spec.scheme == "hashed_elem":
        return alc.alloc_hashed_elem(gids, spec.d, spec.m, spec.seed)
    if spec.scheme == "hashed_row":
        return alc.alloc_hashed_row(gids, spec.d, spec.m, spec.seed)
    return alc.alloc_lma_from_rows(_lma_params(spec), sets, support, gids)


def _bag_locations(spec, gids, sets, support) -> torch.Tensor:
    """gids [B, L] (+ sets [B, L, S], support [B, L]) -> [B, L, d]."""
    B, L = gids.shape
    flat_sets = None if sets is None else sets.reshape(B * L, -1)
    flat_sup = None if support is None else support.reshape(B * L)
    return locations_ref(spec, gids.reshape(B * L), flat_sets,
                         flat_sup).reshape(B, L, spec.d)


def slab_gather(memory, loc, base: int = 0) -> torch.Tensor:
    """``memory[loc - base]`` where that lies in the slab, exact 0
    elsewhere (``repro/kernels/fused_embed/kernel.py:_slab_gather``)."""
    n = memory.shape[0]
    rel = loc.long() - base
    inb = (rel >= 0) & (rel < n)
    vals = memory[torch.clamp(rel, 0, n - 1)]
    return torch.where(inb, vals, torch.zeros((), dtype=memory.dtype,
                                              device=memory.device))


def slab_scatter(loc, g, base: int, m_local: int) -> torch.Tensor:
    """``dM[loc - base] += g`` for the in-slab entries into a zeroed
    ``[m_local]``; out-of-slab entries add nothing."""
    rel = loc.reshape(-1).long() - base
    inb = (rel >= 0) & (rel < m_local)
    dmem = torch.zeros(m_local, dtype=g.dtype, device=g.device)
    return dmem.index_add_(0, rel[inb], g.reshape(-1)[inb])


def fused_lookup_ref(spec, memory, gids, sets=None, support=None,
                     base: int = 0) -> torch.Tensor:
    loc = locations_ref(spec, gids, sets, support)
    if base == 0 and memory.shape[0] == spec.m:
        return lookup(memory, loc)
    return slab_gather(memory, loc, base)


def fused_embed_bag_ref(spec, memory, gids, weights, sets=None,
                        support=None) -> torch.Tensor:
    """gids [B, L] (+ sets [B, L, S], support [B, L]), weights [B, L] ->
    [B, d]: the [B, L, d] gather, then the weighted sum over L."""
    e = lookup(memory, _bag_locations(spec, gids, sets, support))
    return torch.sum(e * weights.to(e.dtype)[:, :, None], dim=1)


def scatter_add_ref(spec, g, gids, sets=None, support=None,
                    weights=None, base: int = 0,
                    m_local: int | None = None) -> torch.Tensor:
    """dM [m] (slab mode: [m_local] from ``base``): flat g [N, d] at the
    [N, d] locations, or bag g [B, d] times weights [B, L] at the [B, L, d]
    locations."""
    if weights is None:
        loc, vals = locations_ref(spec, gids, sets, support), g
    else:
        loc = _bag_locations(spec, gids, sets, support)
        vals = g[:, None, :] * weights.to(g.dtype)[:, :, None]
    if m_local is not None and (base, m_local) != (0, spec.m):
        return slab_scatter(loc, vals, base, m_local)
    dmem = torch.zeros(spec.m, dtype=g.dtype, device=g.device)
    return dmem.index_add_(0, loc.reshape(-1).long(), vals.reshape(-1))


def chunk_lookup_ref(spec, memory, gids, sets=None, support=None,
                     base: int = 0):
    """One exchange chunk: gids [c] (+ sets, support) -> (partial [c, d],
    loc [c, d] int32), the partial the slab-masked gather of the emitted
    locations."""
    loc = locations_ref(spec, gids, sets, support)
    return slab_gather(memory, loc, base), loc


def chunk_gather_ref(memory, loc, base: int = 0) -> torch.Tensor:
    """loc [c, d] global locations -> [c, d] slab-masked partial."""
    return slab_gather(memory, loc, base)


def chunk_scatter_ref(loc, g, base: int, m_local: int) -> torch.Tensor:
    """g [c, d] at the locations loc [c, d] -> dM [m_local], in-slab only."""
    return slab_scatter(loc, g, base, m_local)


def weight_grad_ref(spec, memory, g, gids, sets=None,
                    support=None) -> torch.Tensor:
    """dw [B, L] = <g[b], M[loc[b, l]]>: the gather, then a dot with g."""
    e = lookup(memory, _bag_locations(spec, gids, sets, support))
    return torch.sum(e * g[:, None, :], dim=-1)
