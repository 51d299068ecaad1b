"""Plain PyTorch version of the sparse optimizer update (Adagrad).

A copy of ``repro/kernels/sparse_update/ref.py``'s ``fold_duplicates`` and
``sparse_adagrad_ref``, operation for operation, so on the CPU it is
bit-identical to the reference.  The contract: sorted ``indices [K]``,
either unique with a sentinel tail (``unique=True``: sentinel =
``acc.shape[0]``, values 0 there) or with duplicate runs (``unique=False``,
the bucketed stream, folded here first).  -> the ``[K]`` update values (0 at
sentinel and non-head positions) and the accumulator, which is updated IN
PLACE (add-of-delta at the touched slots, so untouched slots keep their
bits; the reference returns a new array instead).

The sgd and adam versions come with their kernels.
"""
from __future__ import annotations

import torch


def fold_duplicates(indices: torch.Tensor, values: torch.Tensor):
    """Sorted-with-duplicates ``indices [K]`` -> (head [K] bool, folded).

    ``head`` marks the first element of each equal-index run; the folded
    values carry the run's sum at the head and 0 elsewhere.  The sum order is
    the reference's segmented doubling scan: log2(K) steps of
    ``s[p] += s[p + shift] if indices[p + shift] == indices[p]``."""
    k = int(indices.shape[0])
    if k <= 1:
        return torch.ones(k, dtype=torch.bool, device=indices.device), values
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=indices.device),
                      indices[1:] != indices[:-1]])
    s = values
    pos = torch.arange(k, device=indices.device)
    shift = 1
    while shift < k:
        same = (pos < k - shift) & (torch.roll(indices, -shift) == indices)
        same = same.reshape(same.shape + (1,) * (s.dim() - 1))
        s = s + torch.where(same, torch.roll(s, -shift, 0), 0)
        shift *= 2
    headb = head.reshape(head.shape + (1,) * (s.dim() - 1))
    return head, torch.where(headb, s, 0)


def ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root (as numpy, XLA and CUDA's
    ``__fsqrt_rn`` give it): PyTorch's vectorized float32 CPU sqrt can be
    off by one unit in the last place, the float64 root rounded back to
    float32 is not."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def sparse_adagrad_ref(indices, values, acc, *, lr, eps=1e-10, unique=True):
    """-> (update_values [K], (acc,)): dense-Adagrad math per touched slot,
    ``acc += v * v; u = -lr * v / (sqrt(acc) + eps)``."""
    m = acc.shape[0]
    safe = torch.clamp(indices, max=m - 1).long()
    keep = indices < m
    if not unique:
        head, values = fold_duplicates(indices, values)
        keep = keep & head
    vf = values.to(torch.float32)
    sq = vf * vf
    a = acc[safe] + sq
    acc.index_add_(0, safe, torch.where(keep, sq, 0))
    u = -lr * vf / (ieee_sqrt(a) + eps)
    return torch.where(keep, u, 0).to(values.dtype), (acc,)
