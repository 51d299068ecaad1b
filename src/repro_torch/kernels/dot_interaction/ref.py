"""Plain PyTorch version of the dot_interaction kernel.

Pairwise products summed over d for exactly the packed pairs: no matrix
product, so no cuBLAS on the card."""
from __future__ import annotations

import numpy as np
import torch


def tril_pairs(F: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(i, j) of np.tril_indices(F, k=-1), the packed output order."""
    ii, jj = np.tril_indices(F, k=-1)
    return (torch.from_numpy(ii).to(device), torch.from_numpy(jj).to(device))


def dot_interaction_ref(feats: torch.Tensor) -> torch.Tensor:
    """feats [B, F, d] -> [B, F(F-1)/2] strictly-lower-triangular dots."""
    ii, jj = tril_pairs(feats.shape[1], feats.device)
    x = feats.to(torch.float32)
    return (x[:, ii] * x[:, jj]).sum(dim=-1).to(feats.dtype)
