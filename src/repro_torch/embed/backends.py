"""Lookup backends for memory-family schemes, and the resolver.

``split``
    The plain version: materialize the [N, d] location tensor
    (``scheme.locations``) and gather.  The bit-exact oracle.

``fused``
    The CUDA kernel (``repro_torch/kernels/fused_embed``): locations and the
    pool gather (and bag pooling) in one launch.

``sharded``
    The pool (and LMA's D' store) sharded over the 'model' axis of an
    installed mesh (``repro_torch/dist``): this rank's slab, lookups
    through an exchange strategy (psum | ring | all_to_all), chosen per
    lookup by the cost model or pinned by ``REPRO_DIST_EXCHANGE``.  Its
    ``assemble`` gives the whole
    :class:`~repro_torch.dist.sharded_memory.SlabLookup`, whose locations
    are what a sparse gradient records under a mesh: the exchange already
    assembled them in the forward, and nothing is recomputed through the
    sharded store.

``tiered``
    An over-budget pool split by ``repro_torch.tier``: the compact pool
    (hot slab + this step's staged cold rows) and the remap buffers the
    :class:`~repro_torch.tier.training.TierController` rides in each batch.
    The global locations (the fused locations kernel on the card, as
    ``sparse_locations`` computes them; ``scheme.locations`` on the CPU and
    for freq) are remapped into the compact pool and gathered by indexing,
    as the reference's ``jnp.take``: its backward is PyTorch's
    deterministic indexing backward.

The resolver takes the reference's priority: tiered when the buffers carry
tier remap state, else sharded when a mesh is installed, else fused for a
CUDA pool of a scheme with a fused spec, else split (a CPU pool, or a
scheme without a spec, such as freq: the reference's ``fused_eligible``
sends it to split too).  There is no VMEM-style size gate (the kernel reads
the pool from device memory at any size); the fused backend refuses a pool
of another size than the scheme's, a compact tiered pool among them.
``sparse_locations`` is the same choice for the locations a sparse
gradient records on one device.
"""
from __future__ import annotations

import torch

from repro_torch.core.memory import lookup
from repro_torch.embed.config import EmbeddingConfig
from repro_torch.embed.registry import Scheme, get_scheme


class SplitBackend:
    name = "split"

    def lookup(self, cfg: EmbeddingConfig, scheme: Scheme, params: dict,
               buffers: dict, gids: torch.Tensor) -> torch.Tensor:
        return lookup(params["memory"], scheme.locations(cfg, buffers, gids))


class FusedBackend:
    name = "fused"

    @staticmethod
    def _spec(cfg, scheme, params):
        spec = scheme.fused_spec(cfg)
        if spec is None:
            raise ValueError(f"scheme {scheme.kind} has no fused kernel")
        if params["memory"].shape[0] != scheme.memory_slots(cfg):
            raise ValueError("pool size does not match the scheme's slots")
        return spec

    def lookup(self, cfg: EmbeddingConfig, scheme: Scheme, params: dict,
               buffers: dict, gids: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels.fused_embed import ops as fe
        spec = self._spec(cfg, scheme, params)
        extra = scheme.fused_inputs(cfg, buffers, gids)
        return fe.fused_lookup(spec, params["memory"], gids, *extra)

    def bag(self, cfg: EmbeddingConfig, scheme: Scheme, params: dict,
            buffers: dict, gids: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
        """Weighted-sum bags pooled inside the kernel: gids [B, L] global."""
        from repro_torch.kernels.fused_embed import ops as fe
        spec = self._spec(cfg, scheme, params)
        B, L = gids.shape
        extra = scheme.fused_inputs(cfg, buffers, gids.reshape(-1))
        extra = tuple(a.reshape(B, L, *a.shape[1:]) for a in extra)
        return fe.fused_embed_bag(spec, params["memory"], gids, weights,
                                  *extra)


class ShardedBackend:
    name = "sharded"

    def __init__(self, mesh):
        self.mesh = mesh

    def assemble(self, cfg: EmbeddingConfig, scheme: Scheme, params: dict,
                 buffers: dict, gids: torch.Tensor):
        """The scheme's sharded lookup (a ``SlabLookup``)."""
        return scheme.sharded_lookup(cfg, params, buffers, gids, self.mesh)

    def lookup(self, cfg: EmbeddingConfig, scheme: Scheme, params: dict,
               buffers: dict, gids: torch.Tensor) -> torch.Tensor:
        from repro_torch.dist.sharded_memory import attach
        return attach(params["memory"], lambda: self.assemble(
            cfg, scheme, params, buffers, gids))


class TieredBackend:
    name = "tiered"

    def lookup(self, cfg: EmbeddingConfig, scheme: Scheme, params: dict,
               buffers: dict, gids: torch.Tensor) -> torch.Tensor:
        return lookup(params["memory"],
                      tiered_locations(cfg, scheme, buffers, gids))


SPLIT = SplitBackend()
FUSED = FusedBackend()
TIERED = TieredBackend()


def tiered_active(buffers: dict | None) -> bool:
    """Do these buffers carry live tier remap state (hot/stage ids)?"""
    return bool(buffers) and "tier_hot_ids" in buffers


def global_locations(cfg: EmbeddingConfig, scheme: Scheme, buffers: dict,
                     gids: torch.Tensor) -> torch.Tensor:
    """[N] gids -> [N, d] locations in the scheme's full pool: the fused
    locations kernel for CUDA ids of a scheme with a fused spec, else
    ``scheme.locations``; either way bit-identical to
    ``scheme.locations``."""
    spec = scheme.fused_spec(cfg)
    if spec is not None and gids.is_cuda:
        from repro_torch.kernels.fused_embed import ops as fe
        extra = scheme.fused_inputs(cfg, buffers, gids)
        return fe.fused_locations(spec, gids, *extra)
    return scheme.locations(cfg, buffers, gids)


def tiered_locations(cfg: EmbeddingConfig, scheme: Scheme, buffers: dict,
                     gids: torch.Tensor) -> torch.Tensor:
    """The scheme's locations remapped into the compact tiered pool."""
    from repro_torch.tier.store import remap_locations
    return remap_locations(global_locations(cfg, scheme, buffers, gids),
                           buffers["tier_hot_ids"], buffers["tier_stage_ids"],
                           buffers["tier_block"])


def sparse_locations(cfg: EmbeddingConfig, scheme: Scheme, params: dict,
                     buffers: dict, gids: torch.Tensor) -> torch.Tensor:
    """[N] gids -> [N, d] locations for a sparse gradient: the fused
    locations kernel for a CUDA pool (the hash math the scatter kernel would
    recompute to consume them), ``scheme.locations`` for a CPU pool; either
    way bit-identical to ``scheme.locations``.  Under a tier the gradient's
    target is the compact pool, so the locations are the remapped ones."""
    if tiered_active(buffers):
        return tiered_locations(cfg, scheme, buffers, gids)
    if resolve_backend(cfg, params, scheme) is FUSED:
        FUSED._spec(cfg, scheme, params)      # the scheme's whole pool
        return global_locations(cfg, scheme, buffers, gids)
    return scheme.locations(cfg, buffers, gids)


def resolve_backend(cfg: EmbeddingConfig, params: dict,
                    scheme: Scheme | None = None,
                    buffers: dict | None = None):
    """TIERED when the buffers carry tier remap state; else a
    ShardedBackend when a mesh is installed; else FUSED for a CUDA pool
    whose scheme has a fused spec, SPLIT for a CPU pool or a scheme without
    one; None for table-family schemes (they embed directly)."""
    from repro_torch.dist.context import current_mesh
    scheme = get_scheme(cfg.kind) if scheme is None else scheme
    if scheme.family != "memory":
        return None
    if tiered_active(buffers):
        return TIERED
    mesh = current_mesh()
    if mesh is not None:
        return ShardedBackend(mesh)
    if params["memory"].is_cuda and scheme.fused_spec(cfg) is not None:
        return FUSED
    return SPLIT
