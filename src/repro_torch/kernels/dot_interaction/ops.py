"""Public wrapper: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.dot_interaction.kernel import dot_interaction_cuda
from repro_torch.kernels.dot_interaction.ref import dot_interaction_ref


def dot_interaction(feats: torch.Tensor) -> torch.Tensor:
    """feats [B, F, d] -> [B, F(F-1)/2] pairwise dots (strict lower
    triangle, np.tril_indices order)."""
    if feats.is_cuda:
        return dot_interaction_cuda(feats)
    if feats.device.type == "cpu":
        return dot_interaction_ref(feats)
    raise ValueError(f"dot_interaction: unsupported device {feats.device}")

