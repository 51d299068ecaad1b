"""Public wrappers of the fused embed engine, with their gradients.

``fused_lookup``    : value ids (+ D' set rows and support for lma) -> [N, d].
``fused_embed_bag`` : multi-hot [B, L] inputs -> [B, d] weighted-sum bags,
                      pooled inside the kernel.
``fused_locations`` : the [N, d] int32 locations themselves (the indices of
                      a sparse gradient).
``fused_chunk_lookup`` / ``fused_chunk_gather``: the chunked exchange's
                      engine over one rank's slab of a sharded pool
                      (``repro_torch/dist``): a chunk's locations and its
                      slab-masked partial, or the partial of given
                      locations; their backward scatters by the locations.

CUDA tensors go to the kernels, CPU tensors to the plain split versions
(whose gradients PyTorch's autograd takes).  On the card the lookup and the
bag are ``torch.autograd.Function``s mirroring the reference's custom VJPs
(``repro/kernels/fused_embed/ops.py`` ``_lookup``/``_bag``): the forward is
the lookup kernel, the backward the scatter-add kernel (locations
recomputed, not saved), plus the weight-gradient kernel for a bag whose
weights need a gradient; integer inputs get no gradient.

Slab mode (``base`` given): ``memory`` is one rank's ``[m_local]`` slab of
the pool from global slot ``base``; out-of-slab locations read an exact 0
and scatter nothing (the mask-local-gather of the sharded exchange).

A scheme publishes a :class:`FusedSpec` (``Scheme.fused_spec``) and
``repro_torch.embed.backends`` routes CUDA lookups here.  Unlike the TPU
engine there is no VMEM gate (the gather reads device memory, so every pool
size and slab is served, with no slab tiling) and no power-of-two batch
bucketing (that bounded JAX recompiles; PyTorch runs eagerly; nor the
location padding of ``fused_chunk_gather``, which only fed that bucketing).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.allocation import LMAParams
from repro_torch.kernels.fused_embed.kernel import (fused_chunk_gather_cuda,
                                                    fused_chunk_lookup_cuda,
                                                    fused_chunk_scatter_cuda,
                                                    fused_locations_cuda,
                                                    fused_lookup_cuda,
                                                    fused_scatter_add_cuda,
                                                    fused_weight_grad_cuda)
from repro_torch.kernels.fused_embed.ref import (chunk_gather_ref,
                                                 chunk_lookup_ref,
                                                 chunk_scatter_ref,
                                                 fused_embed_bag_ref,
                                                 fused_lookup_ref,
                                                 locations_ref,
                                                 scatter_add_ref)


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


class _Lookup(torch.autograd.Function):
    """Flat lookup on the card: kernel forward, scatter-add backward (into
    the slab when ``base`` is given)."""

    @staticmethod
    def forward(ctx, memory, spec, gids, sets, support, base):
        ctx.spec, ctx.base, ctx.m_local = spec, base, memory.shape[0]
        ctx.save_for_backward(gids, sets, support)
        return fused_lookup_cuda(spec, memory, gids, sets, support,
                                 base=base)

    @staticmethod
    def backward(ctx, g):
        gids, sets, support = ctx.saved_tensors
        slab = {} if ctx.base is None else {"base": ctx.base,
                                            "m_local": ctx.m_local}
        dmem = fused_scatter_add_cuda(ctx.spec, g.contiguous(), gids, sets,
                                      support, **slab)
        return dmem, None, None, None, None, None


def _chunk_scatter(loc, g, base: int, m_local: int) -> torch.Tensor:
    if _on_cpu(g, "chunk scatter"):
        return chunk_scatter_ref(loc, g, base, m_local)
    return fused_chunk_scatter_cuda(loc, g.contiguous(), base, m_local)


class _ChunkLookup(torch.autograd.Function):
    """A chunk's (partial, locations); backward scatters the partial's
    gradient by the emitted locations (the locations get none)."""

    @staticmethod
    def forward(ctx, memory, spec, gids, sets, support, base):
        if _on_cpu(memory, "fused_chunk_lookup"):
            part, loc = chunk_lookup_ref(spec, memory, gids, sets, support,
                                         base)
        else:
            part, loc = fused_chunk_lookup_cuda(spec, memory, gids, sets,
                                                support, base)
        ctx.base, ctx.m_local = base, memory.shape[0]
        ctx.save_for_backward(loc)
        ctx.mark_non_differentiable(loc)
        return part, loc

    @staticmethod
    def backward(ctx, g, _g_loc):
        (loc,) = ctx.saved_tensors
        return (_chunk_scatter(loc, g, ctx.base, ctx.m_local), None, None,
                None, None, None)


class _ChunkGather(torch.autograd.Function):
    """The partial of given locations; backward scatters by them."""

    @staticmethod
    def forward(ctx, memory, loc, base):
        ctx.base, ctx.m_local = base, memory.shape[0]
        ctx.save_for_backward(loc)
        if _on_cpu(memory, "fused_chunk_gather"):
            return chunk_gather_ref(memory, loc, base)
        return fused_chunk_gather_cuda(memory, loc, base)

    @staticmethod
    def backward(ctx, g):
        (loc,) = ctx.saved_tensors
        return _chunk_scatter(loc, g, ctx.base, ctx.m_local), None, None


class _Bag(torch.autograd.Function):
    """Bag lookup on the card: kernel forward; backward the scatter-add
    (g * w) for the pool and the weight-gradient kernel for the weights."""

    @staticmethod
    def forward(ctx, memory, weights, spec, gids, sets, support):
        ctx.spec = spec
        ctx.save_for_backward(memory, weights, gids, sets, support)
        return fused_lookup_cuda(spec, memory, gids, sets, support, weights)

    @staticmethod
    def backward(ctx, g):
        memory, weights, gids, sets, support = ctx.saved_tensors
        g = g.contiguous()
        dmem = dw = None
        if ctx.needs_input_grad[0]:
            dmem = fused_scatter_add_cuda(ctx.spec, g, gids, sets, support,
                                          weights)
        if ctx.needs_input_grad[1]:
            dw = fused_weight_grad_cuda(ctx.spec, memory, g, gids, sets,
                                        support)
        return dmem, dw, None, None, None, None


def fused_lookup(spec: FusedSpec, memory: torch.Tensor, gids: torch.Tensor,
                 sets: torch.Tensor | None = None,
                 support: torch.Tensor | None = None,
                 base: int | None = None) -> torch.Tensor:
    """gids [N] (+ sets [N, S], support [N] for lma) -> [N, d].  With
    ``base``, ``memory`` is the slab from that global slot and out-of-slab
    positions return 0 (for the psum over 'model')."""
    if _on_cpu(memory, "fused_lookup"):
        return fused_lookup_ref(spec, memory, gids, sets, support,
                                base or 0)
    return _Lookup.apply(memory, spec, gids, sets, support, base)


def fused_embed_bag(spec: FusedSpec, memory: torch.Tensor, gids: torch.Tensor,
                    weights: torch.Tensor, sets: torch.Tensor | None = None,
                    support: torch.Tensor | None = None) -> torch.Tensor:
    """gids [B, L], weights [B, L] (+ sets [B, L, S], support [B, L] for
    lma) -> [B, d] weighted-sum bags."""
    if _on_cpu(memory, "fused_embed_bag"):
        return fused_embed_bag_ref(spec, memory, gids, weights, sets, support)
    return _Bag.apply(memory, weights, spec, gids, sets, support)


def fused_locations(spec: FusedSpec, gids: torch.Tensor,
                    sets: torch.Tensor | None = None,
                    support: torch.Tensor | None = None) -> torch.Tensor:
    """gids [N] (+ sets [N, S], support [N] for lma) -> [N, d] int32
    locations, bit-identical to ``Scheme.locations``: the scatter kernel's
    hash recomputation emitted instead of consumed."""
    if _on_cpu(gids, "fused_locations"):
        return locations_ref(spec, gids, sets, support)
    return fused_locations_cuda(spec, gids, sets, support)


def fused_scatter_add(spec: FusedSpec, g: torch.Tensor, gids: torch.Tensor,
                      sets: torch.Tensor | None = None,
                      support: torch.Tensor | None = None, base: int = 0,
                      m_local: int | None = None) -> torch.Tensor:
    """The flat lookup's pool gradient with its locations recomputed: g
    [N, d] -> dM [spec.m], or [m_local] for the slab from ``base``."""
    if _on_cpu(g, "fused_scatter_add"):
        return scatter_add_ref(spec, g, gids, sets, support, base=base,
                               m_local=m_local)
    return fused_scatter_add_cuda(spec, g.contiguous(), gids, sets, support,
                                  base=base, m_local=m_local)


def fused_chunk_lookup(spec: FusedSpec, memory: torch.Tensor,
                       gids: torch.Tensor, sets: torch.Tensor | None = None,
                       support: torch.Tensor | None = None, base: int = 0):
    """One engine call per exchange chunk: gids [c] (+ sets [c, S],
    support [c] for lma) -> ([c, d] slab-masked partial, [c, d] int32
    locations); the partial is bit-identical to ``local_gather(memory,
    locations)``.  Backward scatters the partial's gradient by the emitted
    locations into the slab."""
    return _ChunkLookup.apply(memory, spec, gids, sets, support, base)


def fused_chunk_gather(memory: torch.Tensor, loc: torch.Tensor,
                       base: int = 0) -> torch.Tensor:
    """loc [c, d] int32 global locations -> [c, d] slab-masked partial
    (any scheme's locations); backward scatters by ``loc``."""
    return _ChunkGather.apply(memory, loc, base)


def fused_chunk_scatter(loc: torch.Tensor, g: torch.Tensor, base: int,
                        m_local: int) -> torch.Tensor:
    """g [c, d] at loc [c, d] -> dM [m_local] for the slab from ``base``:
    the gradient of a sharded lookup whose full-batch locations this rank
    holds, in one launch."""
    return _chunk_scatter(loc, g, base, m_local)
