"""Plain PyTorch versions of the fused engine: the split path it replaces.

Locations materialized by the allocators, then a gather (and for bags the
weighted reduce); backward, the scatter-add by ``index_add_`` and the bag
weight gradient by gather and sum.  The kernels are bit-identical to
``locations_ref`` and ``fused_lookup_ref``, and within float32 summation
order of the bag, the scatter-add and the weight gradient.
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


def fused_lookup_ref(spec, memory, gids, sets=None,
                     support=None) -> torch.Tensor:
    return lookup(memory, locations_ref(spec, gids, sets, support))


def fused_embed_bag_ref(spec, memory, gids, weights, sets=None,
                        support=None) -> torch.Tensor:
    """gids [B, L] (+ sets [B, L, S], support [B, L]), weights [B, L] ->
    [B, d]: the [B, L, d] gather, then the weighted sum over L."""
    e = lookup(memory, _bag_locations(spec, gids, sets, support))
    return torch.sum(e * weights.to(e.dtype)[:, :, None], dim=1)


def scatter_add_ref(spec, g, gids, sets=None, support=None,
                    weights=None) -> torch.Tensor:
    """dM [m]: flat g [N, d] at the [N, d] locations, or bag g [B, d] times
    weights [B, L] at the [B, L, d] locations."""
    if weights is None:
        loc, vals = locations_ref(spec, gids, sets, support), g
    else:
        loc = _bag_locations(spec, gids, sets, support)
        vals = g[:, None, :] * weights.to(g.dtype)[:, :, None]
    dmem = torch.zeros(spec.m, dtype=g.dtype, device=g.device)
    return dmem.index_add_(0, loc.reshape(-1).long(), vals.reshape(-1))


def weight_grad_ref(spec, memory, g, gids, sets=None,
                    support=None) -> torch.Tensor:
    """dw [B, L] = <g[b], M[loc[b, l]]>: the gather, then a dot with g."""
    e = lookup(memory, _bag_locations(spec, gids, sets, support))
    return torch.sum(e * g[:, None, :], dim=-1)
