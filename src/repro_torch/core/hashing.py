"""Hashing substrate for SCMA/LMA, in plain PyTorch.

The same murmur3-style family on the ring Z_{2^32} as ``repro.core.hashing``:
odd-multiplier chains finalized with the ``fmix32`` avalanche.  PyTorch has
no usable uint32 on the CPU (``>>``, ``%`` and comparisons raise), so every
value here is an int64 tensor holding a uint32 in ``[0, 2^32)``, and each
product is masked back to 32 bits.  The low 32 bits of a wrapped int64
product are exact, so the results are bit-identical to uint32 arithmetic; a
signed int32 emulation would not be (shifts and ``%`` go wrong for keys
>= 2^31).  The CUDA kernels (``csrc/hash_core.cuh``) use native uint32.

Inputs may be int32 bit patterns (the stored form of signature sets, PAD =
-1); ``u32`` widens them without sign extension.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

MASK = 0xFFFFFFFF
UINT32_MAX = MASK

# murmur3 / splitmix constants
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_M1 = 0xCC9E2D51
_M2 = 0x1B873593


def u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor (int32 bit patterns included) -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & MASK


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    return (x * c) & MASK


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer: full avalanche on Z_{2^32}."""
    x = u32(x)
    x = x ^ (x >> 16)
    x = _mul(x, _C1)
    x = x ^ (x >> 13)
    x = _mul(x, _C2)
    return x ^ (x >> 16)


def seed_stream(base_seed: int, n: int,
                device: torch.device | str | None = None) -> torch.Tensor:
    """Derive ``n`` independent uint32 seeds from one base seed (on the
    card unless ``device`` says otherwise)."""
    idx = torch.arange(n, dtype=torch.int64, device=resolve_device(device))
    return fmix32(((base_seed & MASK) + _GOLDEN * (idx + 1)) & MASK)


def hash_u32(x: torch.Tensor, seed: torch.Tensor | int) -> torch.Tensor:
    """Universal-style hash of uint32 keys ``x`` under ``seed`` (broadcasts)."""
    x = u32(x)
    seed = u32(seed) if isinstance(seed, torch.Tensor) else seed & MASK
    h = _mul(x ^ seed, _M1)
    h = _mul(h ^ (h >> 15), _M2)
    return fmix32(h ^ seed)


def hash_pair(x: torch.Tensor, y: torch.Tensor,
              seed: torch.Tensor | int) -> torch.Tensor:
    """Hash a pair of uint32 keys (e.g. (value, element-index)) under ``seed``."""
    hx = hash_u32(x, seed)
    return hash_u32(u32(y) ^ hx, seed ^ _GOLDEN)


def combine_chain(parts: torch.Tensor, seed: torch.Tensor | int,
                  axis: int = -1) -> torch.Tensor:
    """Fold the ``axis`` dimension of ``parts`` with the order-sensitive
    polynomial chain + final avalanche (the power-k LSH composition psi)."""
    parts = torch.movedim(u32(parts), axis, 0)
    seed = u32(seed) if isinstance(seed, torch.Tensor) else seed & MASK
    h = torch.broadcast_to(torch.as_tensor(seed, device=parts.device),
                           parts.shape[1:])
    for p in parts:
        h = (_mul(h ^ fmix32(p), _M1) + _GOLDEN) & MASK
    return fmix32(h)
