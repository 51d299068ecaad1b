"""Binding of ``csrc/embedding_bag.cu``: the full-table weighted embedding
bag on Hopper, a direct gather.

Replaces ``repro/kernels/embedding_bag/kernel.py`` (``_bag_kernel``,
launched by ``embedding_bag_pallas``), which built a one-hot matrix and
multiplied it on the TPU's matrix unit for want of a fast gather; the source
states the design and what bounds it.  The launch counts in
``embedding_bag_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_I, _L, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p


@functools.cache
def _launch():
    return build.entry("embedding_bag", "embedding_bag_launch",
                       [_P, _P, _P, _L, _I, _I, _I, _P, _P])


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """table [V, d] float32, ids [B, L] int32 in [0, V), weights [B, L]
    float32, all contiguous on the card -> [B, d] float32,
    ``out[b] = sum_l weights[b, l] * table[ids[b, l]]``."""
    build.require(table, "table", torch.float32, 2)
    build.require(ids, "ids", torch.int32, 2)
    build.require(weights, "weights", torch.float32, 2)
    V, d = table.shape
    B, L = ids.shape
    if d > 256:
        raise ValueError(f"row width {d} > 256 (csrc/embedding_bag.cu)")
    if tuple(weights.shape) != (B, L):
        raise ValueError(f"weights {tuple(weights.shape)} do not match ids "
                         f"{tuple(ids.shape)}")
    if not (table.device == ids.device == weights.device):
        raise ValueError("table, ids and weights lie on different devices")
    out = torch.empty((B, d), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        code = _launch()(build.ptr(table), build.ptr(ids),
                         build.ptr(weights), V, d, B, L, build.ptr(out),
                         build.stream(table.device))
    build.check(code, "embedding_bag")
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
