"""Public wrapper with its gradient: the CUDA kernel forward for CUDA
tensors, the plain version for CPU tensors.

The backward is plain PyTorch on both devices: scatter the packed
cotangent into a symmetric [B, F, F] matrix and multiply it with X.  The
reference has no backward kernel to port here (its DLRM computes the
interaction with ``jnp.einsum``, whose gradient XLA derives outside any
Pallas kernel)."""
from __future__ import annotations

import torch

from repro_torch.kernels.dot_interaction.kernel import dot_interaction_cuda
from repro_torch.kernels.dot_interaction.ref import (dot_interaction_ref,
                                                     tril_pairs)


class _DotInteraction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, feats):
        ctx.save_for_backward(feats)
        if feats.is_cuda:
            return dot_interaction_cuda(feats)
        return dot_interaction_ref(feats)

    @staticmethod
    def backward(ctx, gz):
        (x,) = ctx.saved_tensors
        B, F, _ = x.shape
        ii, jj = tril_pairs(F, x.device)
        sym = x.new_zeros((B, F, F))
        sym[:, ii, jj] = gz
        sym[:, jj, ii] = gz
        return torch.bmm(sym, x)


def dot_interaction(feats: torch.Tensor) -> torch.Tensor:
    """feats [B, F, d] -> [B, F(F-1)/2] pairwise dots (strict lower
    triangle, np.tril_indices order)."""
    if not feats.is_cuda and feats.device.type != "cpu":
        raise ValueError(f"dot_interaction: unsupported device {feats.device}")
    return _DotInteraction.apply(feats)
