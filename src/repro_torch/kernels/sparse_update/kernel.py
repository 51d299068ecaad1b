"""Binding of ``csrc/sparse_update.cu``: lazy sparse Adagrad on Hopper.

Replaces ``repro/kernels/sparse_update/kernel.py`` (``_adagrad_kernel`` with
``_gather_keep``, launched by ``sparse_adagrad_pallas``); the source states
the design and what bounds it.  The launch counts in
``sparse_adagrad_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_I, _L, _F, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p
SHORT_RUN = 32       # csrc/sparse_update.cu: longer runs take the warp pass


@functools.cache
def _launch():
    return build.entry("sparse_update", "sparse_adagrad_launch",
                       [_P, _P, _L, _I, _F, _F, _I, _P, _P, _P, _P, _P])


def sparse_adagrad_cuda(indices: torch.Tensor, values: torch.Tensor,
                        acc: torch.Tensor, *, lr: float, eps: float = 1e-10,
                        unique: bool = True) -> torch.Tensor:
    """indices [K] int32 sorted (sentinel = acc.shape[0] when ``unique``),
    values [K] float32, acc [m] float32, all on the card -> the [K] update
    values; ``acc`` is updated in place at the touched slots."""
    build.require(indices, "indices", torch.int32, 1)
    build.require(values, "values", torch.float32, 1)
    build.require(acc, "acc", torch.float32, 1)
    K = indices.shape[0]
    if values.shape[0] != K:
        raise ValueError("values do not match indices")
    dev = acc.device
    u = torch.empty(K, dtype=torch.float32, device=dev)
    long_heads = torch.empty(K // (SHORT_RUN + 1) + 1, dtype=torch.int64,
                             device=dev)
    n_long = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = _launch()(build.ptr(indices), build.ptr(values), K,
                         acc.shape[0], -lr, eps, int(unique), build.ptr(acc),
                         build.ptr(u), build.ptr(long_heads),
                         build.ptr(n_long), build.stream(dev))
    build.check(code, "sparse_adagrad")
    sparse_adagrad_cuda.launches += 1
    return u


sparse_adagrad_cuda.launches = 0
