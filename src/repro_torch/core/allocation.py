"""Allocation functions (paper Definitions 1-2) and the LMA allocation, in
plain PyTorch.

Port of ``repro.core.allocation``: an allocation maps value ids to the ``d``
memory slots their embedding occupies, as a dense ``[B, d]`` int32 location
tensor.  Every function here is bit-identical to its reference counterpart
(hash arithmetic in int64 masked to 32 bits, see ``core.hashing``).  These
are the plain versions the CUDA kernels are held against.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hashing import (combine_chain, hash_pair, hash_u32,
                                      seed_stream, u32)
from repro_torch.core.minhash import minhash_dense
from repro_torch.core.signatures import PAD, DenseSignatureStore

# seed offsets of the rehash stream and of the very-sparse fallback
REHASH_XOR = 0x7F4A7C15
FALLBACK_XOR = 0x1234567


def _slots(h: torch.Tensor, d: int, m: int, stripe: int) -> torch.Tensor:
    """uint32 hash [B, d] -> slot: within stripe i of column i, or % m."""
    if stripe:
        i = torch.arange(d, dtype=torch.int64, device=h.device)[None, :]
        return (i * stripe + h % stripe).to(torch.int32)
    return (h % m).to(torch.int32)


def alloc_full(value_ids: torch.Tensor, d: int) -> torch.Tensor:
    v = value_ids.to(torch.int32)
    return v[:, None] * d + torch.arange(d, dtype=torch.int32,
                                         device=v.device)[None, :]


def alloc_hashed_elem(value_ids: torch.Tensor, d: int, m: int, seed: int,
                      stripe: int = 0) -> torch.Tensor:
    """Element-wise naive hashing trick (HashedNet); ``stripe > 0`` hashes
    position i into its own slot range ``[i*stripe, (i+1)*stripe)``."""
    dev = value_ids.device
    seeds = seed_stream(seed, d, dev)
    v = u32(value_ids)[:, None]
    i = torch.arange(d, dtype=torch.int64, device=dev)[None, :]
    return _slots(hash_pair(v, i, seeds[None, :]), d, m, stripe)


def alloc_hashed_row(value_ids: torch.Tensor, d: int, m: int,
                     seed: int) -> torch.Tensor:
    """Row-wise hashing trick: whole rows collide."""
    dev = value_ids.device
    n_rows = max(m // d, 1)
    row = hash_u32(value_ids, seed_stream(seed, 1, dev)[0]) % n_rows
    return (row[:, None] * d + torch.arange(d, dtype=torch.int64,
                                            device=dev)[None, :]
            ).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class LMAParams:
    """Static hyper-parameters of the LMA allocation (paper section 7.1)."""

    d: int                 # embedding dimension (number of LSH draws)
    m: int                 # memory budget |M|
    n_h: int = 4           # power of each LSH mapping
    seed: int = 0x5C3A
    max_set: int = 64      # cap on |D_v| representation used per lookup
    min_support: int = 2   # |D_v| below this -> fall back to A_h
    independent_hashes: bool = True   # False: sliding windows, d+n_h-1 hashes
    striped: bool = False  # position i maps into its own stripe of m // d

    @property
    def n_raw_hashes(self) -> int:
        return self.d * self.n_h if self.independent_hashes \
            else self.d + self.n_h - 1

    @property
    def stripe(self) -> int:
        """Stripe width when the striped layout is active, else 0 (flat)."""
        return self.m // self.d if (self.striped and self.m % self.d == 0) \
            else 0


def rows_signatures(params: LMAParams, rows: torch.Tensor) -> torch.Tensor:
    """Dense D' rows [B, S] -> raw minhash signatures [B, n_raw_hashes].

    The shared hash core: PAD-mask, truncate to ``params.max_set``, minhash."""
    rows = u32(rows)[:, : params.max_set]
    return minhash_dense(rows, rows != PAD, params.n_raw_hashes, params.seed)


def locations_from_signatures(params: LMAParams,
                              sigs: torch.Tensor) -> torch.Tensor:
    """psi_i composition + rehash into [0, m): [B, R] -> [B, d] int32."""
    B = sigs.shape[0]
    dev = sigs.device
    if params.independent_hashes:
        grouped = sigs.reshape(B, params.d, params.n_h)
    else:
        idx = (torch.arange(params.d, device=dev)[:, None]
               + torch.arange(params.n_h, device=dev)[None, :])
        grouped = sigs[:, idx]                        # sliding windows
    rehash = seed_stream(params.seed ^ REHASH_XOR, params.d, dev)
    h = combine_chain(grouped, rehash[None, :], axis=-1)
    return _slots(h, params.d, params.m, params.stripe)


def lma_or_fallback(params: LMAParams, loc_lma: torch.Tensor,
                    support: torch.Tensor,
                    value_ids: torch.Tensor) -> torch.Tensor:
    """Very-sparse fallback to A_h (paper section 5): |D_v| < min_support."""
    loc_fb = alloc_hashed_elem(value_ids, params.d, params.m,
                               params.seed ^ FALLBACK_XOR,
                               stripe=params.stripe)
    sparse = (support < params.min_support)[:, None]
    return torch.where(sparse, loc_fb, loc_lma)


def alloc_lma_from_rows(params: LMAParams, rows: torch.Tensor,
                        support: torch.Tensor,
                        value_ids: torch.Tensor) -> torch.Tensor:
    """A_L from already-gathered dense D' rows ``store.sets[value_ids]``."""
    loc = locations_from_signatures(params, rows_signatures(params, rows))
    return lma_or_fallback(params, loc, support, value_ids)


def alloc_lma(params: LMAParams, store: DenseSignatureStore,
              value_ids: torch.Tensor) -> torch.Tensor:
    """Full LMA allocation A_L with the very-sparse fallback (dense store)."""
    value_ids = value_ids.long()
    return alloc_lma_from_rows(params, store.sets[value_ids],
                               store.lengths[value_ids], value_ids)
