"""Minwise hashing (paper section 3.3) over padded sets, in plain PyTorch.

Port of ``repro.core.minhash.minhash_dense``.  Memory is bounded by hashing
``chunk`` seeds at a time instead of materializing ``[B, L, n_hashes]``.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import UINT32_MAX, hash_u32, seed_stream


def minhash_dense(elems: torch.Tensor, mask: torch.Tensor, n_hashes: int,
                  seed: int | torch.Tensor, chunk: int = 16) -> torch.Tensor:
    """elems [B, L] uint32 keys (int64 or int32 bit patterns), mask [B, L]
    bool -> signatures [B, n_hashes] (int64 holding uint32).

    Rows with an empty set get UINT32_MAX in every slot (callers fall back
    to the naive hashing trick, paper section 5)."""
    seeds = seed if isinstance(seed, torch.Tensor) else \
        seed_stream(seed, n_hashes, elems.device)
    keep = mask[..., None]
    sigs = []
    for c0 in range(0, n_hashes, chunk):
        h = hash_u32(elems[..., None], seeds[None, None, c0:c0 + chunk])
        h = torch.where(keep, h, UINT32_MAX)
        sigs.append(torch.amin(h, dim=1))
    return torch.cat(sigs, dim=1)
