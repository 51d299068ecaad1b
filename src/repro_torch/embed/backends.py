"""Lookup backends for memory-family schemes, and the resolver.

``split``
    The plain version: materialize the [N, d] location tensor
    (``scheme.locations``) and gather.  The bit-exact oracle.

``fused``
    The CUDA kernel (``repro_torch/kernels/fused_embed``): locations and the
    pool gather (and bag pooling) in one launch.

The resolver picks by where the pool lies and nothing else: a CUDA pool
takes the fused kernel, a CPU pool the split version.  There is no sharded
or tiered backend yet, and no VMEM-style size gate (the kernel reads the
pool from device memory at any size).
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


SPLIT = SplitBackend()
FUSED = FusedBackend()


def resolve_backend(cfg: EmbeddingConfig, params: dict,
                    scheme: Scheme | None = None):
    """FUSED for a CUDA pool, SPLIT for a CPU pool, None for table-family
    schemes (they embed directly)."""
    scheme = get_scheme(cfg.kind) if scheme is None else scheme
    if scheme.family != "memory":
        return None
    return FUSED if params["memory"].is_cuda else SPLIT
