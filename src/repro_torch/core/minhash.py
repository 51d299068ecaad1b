"""Minwise hashing (paper section 3.3) over padded sets, in plain PyTorch.

Port of ``repro.core.minhash``: ``minhash_dense``, ``gather_ragged_sets``
(a CSR store's sets padded to a fixed width) and the host-side
``jaccard_from_sets``.  Memory is bounded by hashing ``chunk`` seeds at a
time instead of materializing ``[B, L, n_hashes]``.
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


def gather_ragged_sets(flat: torch.Tensor, offsets: torch.Tensor,
                       value_ids: torch.Tensor,
                       max_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``D_v`` of a batch of values from a CSR store, padded to ``max_len``.

    ``flat [nnz]`` (int32 bit patterns of uint32 sample ids), ``offsets
    [n_values + 1]`` -> (elems [B, max_len] of ``flat``'s dtype, mask
    [B, max_len] bool).  Longer sets are truncated; padding positions read
    a clamped index, as the reference's do, and are masked out."""
    ids = value_ids.long()
    start = offsets[ids].long()
    length = offsets[ids + 1].long() - start
    pos = torch.arange(max_len, dtype=torch.int64, device=flat.device)[None]
    mask = pos < torch.clamp(length, max=max_len)[:, None]
    if flat.numel() == 0:
        return torch.zeros(mask.shape, dtype=flat.dtype,
                           device=flat.device), mask
    idx = torch.clamp(start[:, None] + pos, 0, flat.numel() - 1)
    return flat[idx], mask


def jaccard_from_sets(a: set, b: set) -> float:
    """Host-side exact Jaccard (test/benchmark oracle)."""
    if not a and not b:
        return 1.0
    return len(a & b) / max(1, len(a | b))
