"""Binding of ``csrc/sparse_update.cu``: lazy sparse Adagrad, momentum SGD
and Adam on Hopper.

Replaces ``repro/kernels/sparse_update/kernel.py`` (``_adagrad_kernel``,
``_sgd_kernel`` and ``_adam_kernel`` with ``_gather_keep``, launched by
``sparse_adagrad_pallas``, ``sparse_sgd_pallas`` and ``sparse_adam_pallas``);
the source states the design and what bounds it.  Both layouts: flat states
``[m]`` with values ``[K]``, or ``[rows, d]`` states with values ``[K, d]``
(d <= 256), and Adam's row-wise ``nu [rows]``.  Each wrapper counts its
launches in ``<fn>.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_I, _L, _F, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p
TILE = 2048          # csrc/sparse_update.cu: flat entries a pass-1 block owns
MAX_D = 256          # csrc/sparse_update.cu: the widest row


@functools.cache
def _launch(symbol: str):
    head = [_P, _P, _L, _I, _I, _I]            # idx, val, K, m, d, unique
    tail = [_P, _P]                            # u, long_head
    scalars = {"sparse_adagrad_launch": [_F, _F, _P],
               "sparse_sgd_launch": [_F, _F, _P],
               "sparse_adam_launch": [_I] + [_F] * 8 + [_P, _P]}[symbol]
    return build.entry("sparse_update", symbol, head + scalars + tail + [_P])


def _layout(indices, values, states: tuple) -> int:
    """Check the operands; -> d (0 for the flat layout)."""
    build.require(indices, "indices", torch.int32, 1)
    if values.dim() not in (1, 2):
        raise ValueError(f"values must be [K] or [K, d], got "
                         f"{tuple(values.shape)}")
    build.require(values, "values", torch.float32, values.dim())
    K = indices.shape[0]
    if values.shape[0] != K:
        raise ValueError("values do not match indices")
    d = values.shape[1] if values.dim() == 2 else 0
    if d > MAX_D:
        raise ValueError(f"row width {d} > {MAX_D}")
    lead = states[0].shape[0]
    for s in states:
        build.require(s, "state", torch.float32, s.dim())
        if s.shape[0] != lead or s.device != values.device:
            raise ValueError("states do not share a leading dim and device")
    return d


def _run(symbol: str, indices, values, states: tuple, scalars: list,
         unique: bool) -> torch.Tensor:
    d = _layout(indices, values, states)
    K, dev = indices.shape[0], values.device
    u = torch.empty_like(values)
    long_head = None                   # a flat fold's runs past a tile
    if d == 0 and not unique:
        long_head = torch.empty(-(-K // TILE), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        code = _launch(symbol)(
            build.ptr(indices), build.ptr(values), K, states[0].shape[0], d,
            int(unique), *scalars, *(build.ptr(s) for s in states),
            build.ptr(u), build.ptr(long_head), build.stream(dev))
    build.check(code, symbol)
    return u


def sparse_adagrad_cuda(indices: torch.Tensor, values: torch.Tensor,
                        acc: torch.Tensor, *, lr: float, eps: float = 1e-10,
                        unique: bool = True) -> torch.Tensor:
    """indices [K] int32 sorted (sentinel = acc.shape[0] when ``unique``),
    values [K] with acc [m], or [K, d] with acc [rows, d], float32 on the
    card -> the update values; ``acc`` is updated in place at the touched
    slots."""
    if acc.dim() != values.dim():
        raise ValueError("Adagrad's accumulator must match the values' rank")
    u = _run("sparse_adagrad_launch", indices, values, (acc,), [-lr, eps],
             unique)
    sparse_adagrad_cuda.launches += 1
    return u


def sparse_sgd_cuda(indices: torch.Tensor, values: torch.Tensor,
                    mo: torch.Tensor, *, lr: float, momentum: float,
                    unique: bool = True) -> torch.Tensor:
    """Lazy momentum SGD; the contract of ``sparse_adagrad_cuda`` with the
    momentum state ``mo`` ([m] or [rows, d]) in place of ``acc``."""
    if mo.dim() != values.dim():
        raise ValueError("the momentum must match the values' rank")
    u = _run("sparse_sgd_launch", indices, values, (mo,), [momentum, -lr],
             unique)
    sparse_sgd_cuda.launches += 1
    return u


def sparse_adam_cuda(indices: torch.Tensor, values: torch.Tensor,
                     mu: torch.Tensor, nu: torch.Tensor, *, lr: float,
                     b1: float = 0.9, b2: float = 0.999, bc1: float = 1.0,
                     bc2: float = 1.0, eps: float = 1e-8,
                     unique: bool = True) -> torch.Tensor:
    """Lazy Adam with global-step bias corrections ``bc1``/``bc2`` (float32
    values); ``mu`` matches the values' layout, ``nu`` too or, against
    [K, d] values, is row-wise [rows]."""
    rowwise = nu.dim() == 1 and values.dim() == 2
    if mu.dim() != values.dim() or not (rowwise or nu.dim() == values.dim()):
        raise ValueError("Adam's moments do not match the values' layout")
    u = _run("sparse_adam_launch", indices, values, (mu, nu),
             [int(rowwise), b1, 1 - b1, b2, 1 - b2, -lr, bc1, bc2, eps],
             unique)
    sparse_adam_cuda.launches += 1
    return u


sparse_adagrad_cuda.launches = 0
sparse_sgd_cuda.launches = 0
sparse_adam_cuda.launches = 0
