"""Binding of ``csrc/cin.cu``: the xDeepFM CIN layer on Hopper.

Replaces ``repro/kernels/cin/kernel.py`` (``_cin_kernel``, launched by
``cin_pallas``); the source states the design and what bounds it.  The raw
forward launch; its gradient is ``ops.cin``'s.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_I, _P = ctypes.c_int, ctypes.c_void_p


@functools.cache
def _launch():
    return build.entry("cin", "cin_launch", [_P, _P, _P, _I, _I, _I, _I, _I,
                                             _P, _P, _P])


@functools.cache
def _scratch_floats():
    fn = getattr(build.load("cin"), "cin_scratch_floats")
    fn.argtypes = [_I] * 5
    fn.restype = ctypes.c_int64
    return fn


def cin_cuda(xk: torch.Tensor, x0: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """xk [B, Hk, d], x0 [B, F, d], w [Ho, Hk, F], float32 and contiguous on
    the card -> out [B, Ho, d] float32,
    ``out[b, o, e] = sum_{h, f} w[o, h, f] * xk[b, h, e] * x0[b, f, e]``."""
    build.require(xk, "xk", torch.float32, 3)
    build.require(x0, "x0", torch.float32, 3)
    build.require(w, "w", torch.float32, 3)
    B, Hk, d = xk.shape
    F = x0.shape[1]
    Ho = w.shape[0]
    if x0.shape[0] != B or x0.shape[2] != d:
        raise ValueError(f"x0 {tuple(x0.shape)} does not match xk "
                         f"{tuple(xk.shape)}")
    if tuple(w.shape[1:]) != (Hk, F):
        raise ValueError(f"w {tuple(w.shape)} is not [Ho, {Hk}, {F}]")
    if max(xk.numel(), x0.numel(), w.numel()) >= 2**31:
        raise ValueError("cin: an operand of 2^31 or more elements")
    if not (xk.device == x0.device == w.device):
        raise ValueError("xk, x0 and w lie on different devices")
    out = torch.empty((B, Ho, d), dtype=torch.float32, device=xk.device)
    n_scratch = _scratch_floats()(B, Hk, F, d, Ho)   # W's tiles, partials
    scratch = torch.empty(n_scratch, dtype=torch.float32,
                          device=xk.device) if n_scratch else None
    with torch.cuda.device(xk.device):
        code = _launch()(build.ptr(xk), build.ptr(x0), build.ptr(w), B, Hk,
                         F, d, Ho, build.ptr(out), build.ptr(scratch),
                         build.stream(xk.device))
    build.check(code, "cin")
    cin_cuda.launches += 1
    return out


cin_cuda.launches = 0
