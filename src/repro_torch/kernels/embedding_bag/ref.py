"""Plain PyTorch version of the full-table weighted embedding bag (copy of
``repro/kernels/embedding_bag/ref.py``): a gather and an einsum."""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """table [V, d], ids [B, L], weights [B, L] -> [B, d],
    ``out[b] = sum_l weights[b, l] * table[ids[b, l]]``."""
    gathered = table[ids.long()]                        # [B, L, d]
    return torch.einsum("bl,bld->bd", weights.to(table.dtype), gathered)
