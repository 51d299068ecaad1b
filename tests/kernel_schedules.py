"""Plain-PyTorch emulations of two CUDA kernels' schedules, for the tests.

Nothing in ``repro_torch`` imports this module, and it imports no JAX, so
the CPU tests and the card-only tests (``test_torch_kernels_cuda.py``) both
use it:

- ``dot_interaction_schedule``: ``csrc/dot_interaction.cu``'s groups of G
  samples walked by a persistent grid, its register tiles
  (``kernel.dot_tiles``) and the contiguous output span of each group, each
  written place counted;
- ``weight_grad_lanes``: ``fused_weight_grad_kernel``'s order of sums (each
  lane's columns c = lane, lane + 32, ..., product then sum, then the
  xor-shuffle tree 16, 8, 4, 2, 1), every operation rounded to float32 alone
  as the kernel rounds it, so on the card it gives the kernel's bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dot_interaction.kernel import TI, TJ

WARP = 32


def dot_interaction_schedule(x: torch.Tensor, G: int, grid: int,
                             tiles) -> torch.Tensor:
    """x [B, F, d] -> [B, F(F-1)/2] by the kernel's schedule: block ``blk``
    of ``grid`` takes groups blk, blk + grid, ...; each group's samples are
    computed tile by tile into a [G, P] staging row, which is copied to the
    group's span of the output, 4 floats at a time where the spans are
    4-float aligned, then the tail.  Raises unless every pair of a group is
    written once to staging and every output place once."""
    B, F, d = x.shape
    P = F * (F - 1) // 2
    t = torch.as_tensor(tiles, dtype=torch.int64)
    i0, j0, nt = t & 0x3FF, (t >> 10) & 0x3FF, t >> 20
    rows_i = i0[:, None] + torch.arange(TI)                 # [T, TI]
    rows_j = j0[:, None] + torch.arange(TJ) * nt[:, None]   # [T, TJ]
    ii, jj = rows_i[:, :, None], rows_j[:, None, :]
    valid = (ii < F) & (jj < ii)                             # [T, TI, TJ]
    place = (ii * (ii - 1) // 2 + jj).expand(valid.shape)
    ra, rb = rows_i.clamp(max=F - 1), rows_j.clamp(max=F - 1)
    out = torch.full((B * P,), float("nan"), dtype=x.dtype)
    stored = torch.zeros(B * P, dtype=torch.int64)
    n_groups = -(-B // G)
    vec_out = (G * P) % 4 == 0
    for blk in range(min(grid, n_groups)):
        for grp in range(blk, n_groups, grid):
            ns = min(G, B - grp * G)
            zs = torch.full((G * P,), float("nan"), dtype=x.dtype)
            hits = torch.zeros(G * P, dtype=torch.int64)
            for s in range(ns):
                xs = x[grp * G + s]
                A, Bm = xs[ra], xs[rb]          # [T, TI, d], [T, TJ, d]
                acc = torch.zeros((len(t), TI, TJ), dtype=x.dtype)
                for k in range(d):              # the chain's order over k
                    acc = acc + A[:, :, None, k] * Bm[:, None, :, k]
                zs[s * P + place[valid]] = acc[valid]
                hits.index_add_(0, s * P + place[valid],
                                torch.ones_like(place[valid]))
            if not torch.equal(hits[:ns * P], torch.ones(ns * P,
                                                         dtype=torch.int64)):
                raise AssertionError(f"group {grp}: a pair written "
                                     "twice or never")
            o, n = grp * G * P, ns * P
            q0 = n // 4 * 4 if vec_out else 0
            for q in range(0, q0, 4):           # 16-byte stores
                out[o + q:o + q + 4] = zs[q:q + 4]
            out[o + q0:o + n] = zs[q0:n]        # the tail, one float each
            stored[o:o + n] += 1
    if not torch.equal(stored, torch.ones_like(stored)):
        raise AssertionError("an output place written twice or never")
    return out.view(B, P)


def weight_grad_lanes(e: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """e [B, L, d] (the gathered rows M[loc[b, l]]), g [B, d] -> dw [B, L]
    in the kernel's order of sums."""
    B, L, d = e.shape
    prod = e * g[:, None, :]
    lanes = torch.zeros((B, L, WARP), dtype=e.dtype, device=e.device)
    for c0 in range(0, d, WARP):
        w = min(WARP, d - c0)
        lanes[..., :w] = lanes[..., :w] + prod[..., c0:c0 + w]
    lane = torch.arange(WARP, device=e.device)
    off = WARP // 2
    while off:
        lanes = lanes + lanes[..., lane ^ off]
        off //= 2
    return lanes[..., 0].contiguous()
