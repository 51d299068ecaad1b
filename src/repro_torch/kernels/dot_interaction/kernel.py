"""Binding of ``csrc/dot_interaction.cu``: the DLRM interaction on Hopper.

Replaces ``repro/kernels/dot_interaction/kernel.py`` (``_dot_kernel``); the
source states the design and what bounds it.  The raw forward launch; its
gradient is ``ops.dot_interaction``'s.  The schedule's host side is here:
the tile list (``dot_tiles``), the samples a block takes at a time
(``group_size``) and the shared memory they need (``smem_bytes``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build

_I, _P = ctypes.c_int, ctypes.c_void_p
TI, TJ = 2, 4              # a thread's tile: TI rows i by TJ rows j
GROUP = 4                  # samples a block takes at a time at large batches
GROUP_FROM = 64            # ... once the batch holds this many samples an SM
MAX_F = 1023               # a tile packs i0, j0 and nt in 10 bits each
MAX_SMEM = 232448          # a block's opt-in shared memory on sm_90 (227 KB)


@functools.cache
def _launch():
    return build.entry("dot_interaction", "dot_interaction_launch",
                       [_P, _I, _I, _I, _I, _I, _P, _I, _P, _P])


def dot_tiles(F: int) -> np.ndarray:
    """The tiles that cover the strict lower triangle of an F x F product,
    int32 packed ``i0 | j0 << 10 | nt << 20``.  Tile (i0, j0, nt) holds the
    pairs (i0 + a, j0 + b * nt) for a < TI, b < TJ; those with j >= i or
    i >= F are computed from clamped rows and dropped.  Rows i0 = 1, 1 + TI,
    ... each take nt = ceil(J / TJ) tiles, J the columns the block's last
    row needs, and tile j0 = 0..nt-1 of them the columns j0 + b * nt."""
    if not 2 <= F <= MAX_F:
        raise ValueError(f"F={F} outside [2, {MAX_F}]")
    out = []
    for i0 in range(1, F, TI):
        J = min(i0 + TI - 1, F - 1)      # j < i <= the block's last row
        nt = -(-J // TJ)
        out += [i0 | j0 << 10 | nt << 20 for j0 in range(nt)]
    return np.asarray(out, dtype=np.int32)


def row_stride(d: int, vec: bool) -> int:
    """Floats between staged rows: an odd number of 16-byte (vec) or 4-byte
    words, as ``csrc/dot_interaction.cu`` lays them out."""
    v = 4 if vec else 1
    return v * ((d // v) | 1)


def smem_bytes(F: int, d: int, G: int, vec: bool) -> int:
    """A block's shared memory: G packed rows (rounded up to 4 floats), then
    two buffers of G staged samples."""
    P = F * (F - 1) // 2
    return 4 * ((G * P + 3) // 4 * 4 + 2 * G * F * row_stride(d, vec))


def group_size(B: int, F: int, d: int, vec: bool, sms: int) -> int:
    """Samples a block takes at a time: GROUP once the batch holds
    GROUP_FROM samples an SM, so that each block of the persistent grid
    walks several groups and the last round's imbalance is small; else (or
    where GROUP samples do not fit a block) 1, whose finer groups spread a
    smaller batch evenly over the SMs."""
    if B >= GROUP_FROM * sms and smem_bytes(F, d, GROUP, vec) <= MAX_SMEM:
        return GROUP
    return 1


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _tiles_on(F: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(dot_tiles(F)).to(device)


def dot_interaction_cuda(feats: torch.Tensor) -> torch.Tensor:
    """feats [B, F, d] float32 on the card -> [B, F(F-1)/2] float32."""
    build.require(feats, "feats", torch.float32, 3)
    B, F, d = feats.shape
    vec = d % 4 == 0 and d > 0 and feats.data_ptr() % 16 == 0
    if F > MAX_F or smem_bytes(F, d, 1, vec) > MAX_SMEM:
        raise ValueError(f"[F={F}, d={d}] does not fit one block's shared "
                         "memory")
    out = torch.empty((B, F * (F - 1) // 2), dtype=torch.float32,
                      device=feats.device)
    if F < 2:
        return out
    G = group_size(B, F, d, vec, _sms(feats.device))
    tiles = _tiles_on(F, feats.device)
    with torch.cuda.device(feats.device):
        code = _launch()(build.ptr(feats), B, F, d, G, int(vec),
                         build.ptr(tiles), tiles.numel(), build.ptr(out),
                         build.stream(feats.device))
    build.check(code, "dot_interaction")
    dot_interaction_cuda.launches += 1
    return out


dot_interaction_cuda.launches = 0
