"""Public wrappers of the fused embed engine (forward).

``fused_lookup``   : value ids (+ D' set rows and support for lma) -> [N, d].
``fused_embed_bag``: multi-hot [B, L] inputs -> [B, d] weighted-sum bags,
                     pooled inside the kernel.

CUDA tensors go to the kernel, CPU tensors to the plain split version.  A
scheme publishes a :class:`FusedSpec` (``Scheme.fused_spec``) and
``repro_torch.embed.backends`` routes CUDA lookups here.  Unlike the TPU
engine there is no VMEM gate (the gather reads device memory, so every pool
size is served) and no power-of-two batch bucketing (that bounded JAX
recompiles; PyTorch runs eagerly).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.allocation import LMAParams
from repro_torch.kernels.fused_embed.kernel import fused_lookup_cuda
from repro_torch.kernels.fused_embed.ref import (fused_embed_bag_ref,
                                                 fused_lookup_ref)


@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """Static description of one fused lookup family."""

    scheme: str            # lma | hashed_elem | hashed_row
    d: int
    m: int
    seed: int
    n_h: int = 4
    max_set: int = 64
    min_support: int = 2
    independent: bool = True
    striped: bool = False   # striped location layout (LMAParams.striped)

    @property
    def n_raw_hashes(self) -> int:
        return self.d * self.n_h if self.independent else self.d + self.n_h - 1

    @property
    def stripe(self) -> int:
        """Stripe width when the striped layout is active, else 0 (flat)."""
        return self.m // self.d if (self.striped and self.m % self.d == 0) \
            else 0


def lma_spec(p: LMAParams) -> FusedSpec:
    return FusedSpec("lma", p.d, p.m, p.seed, p.n_h, p.max_set,
                     p.min_support, p.independent_hashes, p.striped)


def hashed_spec(kind: str, d: int, m: int, seed: int) -> FusedSpec:
    if kind not in ("hashed_elem", "hashed_row"):
        raise ValueError(kind)
    return FusedSpec(kind, d, m, seed)


def _on_cpu(t: torch.Tensor, what: str) -> bool:
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"{what}: unsupported device {t.device}")


def fused_lookup(spec: FusedSpec, memory: torch.Tensor, gids: torch.Tensor,
                 sets: torch.Tensor | None = None,
                 support: torch.Tensor | None = None) -> torch.Tensor:
    """gids [N] (+ sets [N, S], support [N] for lma) -> [N, d]."""
    if _on_cpu(memory, "fused_lookup"):
        return fused_lookup_ref(spec, memory, gids, sets, support)
    return fused_lookup_cuda(spec, memory, gids, sets, support)


def fused_embed_bag(spec: FusedSpec, memory: torch.Tensor, gids: torch.Tensor,
                    weights: torch.Tensor, sets: torch.Tensor | None = None,
                    support: torch.Tensor | None = None) -> torch.Tensor:
    """gids [B, L], weights [B, L] (+ sets [B, L, S], support [B, L] for
    lma) -> [B, d] weighted-sum bags."""
    if _on_cpu(memory, "fused_embed_bag"):
        return fused_embed_bag_ref(spec, memory, gids, weights, sets, support)
    return fused_lookup_cuda(spec, memory, gids, sets, support, weights)
