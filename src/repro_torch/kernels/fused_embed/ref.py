"""Plain PyTorch version of the fused lookup: the split path it replaces.

Locations materialized by the allocators, then a gather (and for bags the
weighted reduce).  The kernel is bit-identical to ``fused_lookup_ref`` and
within float32 summation order of ``fused_embed_bag_ref``.
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


def fused_lookup_ref(spec, memory, gids, sets=None,
                     support=None) -> torch.Tensor:
    return lookup(memory, locations_ref(spec, gids, sets, support))


def fused_embed_bag_ref(spec, memory, gids, weights, sets=None,
                        support=None) -> torch.Tensor:
    """gids [B, L] (+ sets [B, L, S], support [B, L]), weights [B, L] ->
    [B, d]: the [B, L, d] gather, then the weighted sum over L."""
    B, L = gids.shape
    flat_sets = None if sets is None else sets.reshape(B * L, -1)
    flat_sup = None if support is None else support.reshape(B * L)
    e = fused_lookup_ref(spec, memory, gids.reshape(B * L), flat_sets,
                         flat_sup).reshape(B, L, spec.d)
    return torch.sum(e * weights.to(e.dtype)[:, :, None], dim=1)
