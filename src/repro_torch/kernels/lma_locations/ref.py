"""Plain PyTorch version of the lma_locations kernel (bit-exact)."""
from __future__ import annotations

import torch

from repro_torch.core.allocation import LMAParams, locations_from_signatures
from repro_torch.core.hashing import u32
from repro_torch.core.minhash import minhash_dense
from repro_torch.core.signatures import PAD


def lma_locations_ref(params: LMAParams, sets: torch.Tensor) -> torch.Tensor:
    """sets [B, S] (PAD sentinel) -> [B, d] int32 locations, no fallback."""
    sets = u32(sets)
    sigs = minhash_dense(sets, sets != PAD, params.n_raw_hashes, params.seed)
    return locations_from_signatures(params, sigs)
