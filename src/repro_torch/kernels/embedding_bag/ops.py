"""The embedding-bag entry point (port of
``repro.kernels.embedding_bag.ops.embedding_bag``): the CUDA kernel for a
table on the card, the plain version for a table on the CPU.  Forward only,
as the reference's (its ``pallas_call`` has no gradient rule)."""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """table [V, d], ids [B, L], weights [B, L] -> [B, d] weighted-sum
    bags."""
    if table.is_cuda:
        return embedding_bag_cuda(table, ids, weights)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, weights)
    raise ValueError(f"embedding_bag: unsupported device {table.device}")
