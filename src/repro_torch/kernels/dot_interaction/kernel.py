"""Binding of ``csrc/dot_interaction.cu``: the DLRM interaction on Hopper.

Replaces ``repro/kernels/dot_interaction/kernel.py`` (``_dot_kernel``); the
source states the design and what bounds it.  Forward only: the backward
comes with the training slice, so an input that needs a gradient raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_I, _P = ctypes.c_int, ctypes.c_void_p
_MAX_SHARED = 48 * 1024    # static launch limit without an opt-in


@functools.cache
def _launch():
    return build.entry("dot_interaction", "dot_interaction_launch",
                       [_P, _I, _I, _I, _P, _P])


def dot_interaction_cuda(feats: torch.Tensor) -> torch.Tensor:
    """feats [B, F, d] float32 on the card -> [B, F(F-1)/2] float32."""
    build.require(feats, "feats", torch.float32, 3)
    if torch.is_grad_enabled() and feats.requires_grad:
        raise RuntimeError("dot_interaction_cuda has no backward kernel yet; "
                           "call it under torch.no_grad() or inference_mode")
    B, F, d = feats.shape
    if F * (d + 1) * 4 > _MAX_SHARED:
        raise ValueError(f"[F={F}, d={d}] does not fit one block's shared "
                         "memory")
    out = torch.empty((B, F * (F - 1) // 2), dtype=torch.float32,
                      device=feats.device)
    with torch.cuda.device(feats.device):
        code = _launch()(build.ptr(feats), B, F, d, build.ptr(out),
                         build.stream(feats.device))
    build.check(code, "dot_interaction")
    dot_interaction_cuda.launches += 1
    return out


dot_interaction_cuda.launches = 0
