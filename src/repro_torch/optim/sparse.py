"""Sparse gradients for the memory pool (port of ``repro.optim.sparse``).

A batch touches at most ``B * L * d`` of the pool's ``m`` slots, yet a
dense step materializes an ``[m]`` gradient and runs the optimizer over all
of it.  This module replaces both with O(K) work.

``SparseGrad``
    The gradient of one pool as sorted ``indices [K]`` and ``values [K]``,
    in one of the reference's two layouts: deduped (``unique=True``: sorted
    unique slots, sentinel-padded, summed values; ``dedup_locations``) or
    bucketed (``unique=False``: sorted with duplicates, built stripe-major by
    ``from_bucketed_locations`` without a global sort; the update folds the
    duplicates).  ``densify()`` is the exact dense oracle.

``capture()``
    PyTorch's counterpart of the reference's record/provide pair
    (``sparse_value_and_grad``).  While a capture is active, every memory
    lookup (``repro_torch/embed/table.py``) goes through an
    ``autograd.Function`` whose forward is the normal lookup and whose
    backward computes the lookup's ``[N, d]`` locations (the fused locations
    kernel on the card, ``scheme.locations`` on the CPU), keeps them with
    the incoming ``[N, d]`` gradient in forward call order, and returns no
    gradient for the pool.  So the pool's ``.grad`` stays ``None`` and no
    ``[m]`` gradient is ever allocated.  After ``backward()``,
    ``SparseCapture.grads`` builds one ``SparseGrad`` per pool by the
    reference's rule (``sparse.py:394-426``): bucketed when the scheme
    declares stripe buckets (striped lma), flat dedup otherwise.  Row mode
    (``record_rows``: one index per pool row for hashed_row) is not ported;
    hashed_row records element-level locations, as the reference does for a
    ragged budget.

``sparse_adagrad``
    Lazy Adagrad: the pool leaf's update is one pass over the K entries
    (``repro_torch/kernels/sparse_update``), exactly the dense update.

Gate: ``REPRO_SPARSE_GRADS`` (default on; ``=0`` keeps the dense path as the
oracle), as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable

import torch

from repro_torch.optim.optimizers import Optimizer, adagrad


def sparse_enabled() -> bool:
    """The ``REPRO_SPARSE_GRADS`` gate (default on)."""
    return os.environ.get("REPRO_SPARSE_GRADS", "1").lower() not in (
        "0", "false", "off", "no")


# ---------------------------------------------------------------- SparseGrad

@dataclasses.dataclass(frozen=True)
class SparseGrad:
    """Sorted sparse gradient of one dense parameter (usually the pool M).

    ``unique=True``: ``indices`` are sorted unique slots compacted to the
    front and padded with the sentinel ``dense_shape[0]`` (values 0 there).
    ``unique=False``: sorted with duplicates, no sentinels; ``buckets`` (d)
    records that the stream is stripe-major."""

    indices: torch.Tensor          # [K] int32
    values: torch.Tensor           # [K, *dense_shape[1:]]
    dense_shape: tuple[int, ...]
    unique: bool = True
    buckets: int = 0

    @property
    def sentinel(self) -> int:
        return int(self.dense_shape[0])

    def densify(self) -> torch.Tensor:
        """The dense oracle: scatter-add into zeros, sentinels dropped."""
        keep = self.indices < self.sentinel
        z = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                        device=self.values.device)
        return z.index_add_(0, self.indices[keep].long(), self.values[keep])

    def map_values(self, fn) -> "SparseGrad":
        return dataclasses.replace(self, values=fn(self.values))

    def all_finite(self, max_abs: float | None = None) -> bool:
        ok = bool(torch.isfinite(self.values).all())
        if max_abs is not None:
            ok = ok and bool((self.values.abs() <= max_abs).all())
        return ok


def is_sparse(x) -> bool:
    return isinstance(x, SparseGrad)


def dedup_locations(loc: torch.Tensor, vals: torch.Tensor,
                    dense_shape: tuple[int, ...]) -> SparseGrad:
    """Sort locations, sum coincident values: ``loc [K]`` (duplicates
    allowed), ``vals [K, ...]`` -> sorted unique indices compacted to the
    front, padded with the sentinel ``dense_shape[0]`` (values 0 there)."""
    k = int(loc.shape[0])
    si, order = torch.sort(loc, stable=True)
    si = si.to(torch.int32)
    sv = vals[order]
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=loc.device),
                      si[1:] != si[:-1]])
    seg = torch.cumsum(head, 0) - 1
    summed = torch.zeros((k,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                         device=vals.device).index_add_(0, seg, sv)
    idx = torch.full((k,), dense_shape[0], dtype=torch.int32,
                     device=loc.device).scatter_(0, seg, si)
    return SparseGrad(idx, summed, tuple(dense_shape))


def from_locations(loc: torch.Tensor, vals: torch.Tensor,
                   dense_shape: tuple[int, ...]) -> SparseGrad:
    """[..., d] location tensor + matching gradient values -> SparseGrad."""
    trailing = tuple(dense_shape[1:])
    return dedup_locations(loc.reshape(-1), vals.reshape((-1,) + trailing),
                           dense_shape)


def from_bucketed_locations(loc: torch.Tensor, vals: torch.Tensor,
                            dense_shape: tuple[int, ...]) -> SparseGrad:
    """Striped layout: [N, d] locations whose column j lies in stripe
    ``[j*(m//d), (j+1)*(m//d))`` -> a sorted-with-duplicates SparseGrad
    (``unique=False``, ``buckets=d``) by d independent stable sorts of the
    in-stripe offsets, the values riding along (no global sort).  Falls back
    to ``from_locations`` for trailing dims or a ragged budget."""
    if len(dense_shape) != 1 or loc.dim() != 2:
        return from_locations(loc, vals, dense_shape)
    m = int(dense_shape[0])
    n, d = int(loc.shape[0]), int(loc.shape[1])
    if n == 0 or d == 0 or m % d != 0:
        return from_locations(loc, vals, dense_shape)
    stripe = m // d
    col = torch.arange(d, dtype=torch.int32, device=loc.device)[:, None]
    base = col * stripe
    off = loc.t().to(torch.int32) - base                   # [d, N]
    # stability keeps coincident slots in emission order (the reference's
    # lax.sort(..., is_stable=True) over (offset, value) pairs)
    soff, perm = torch.sort(off, dim=1, stable=True)
    sval = torch.gather(vals.reshape(n, d).t(), 1, perm)
    idx = (soff + base).reshape(-1)
    return SparseGrad(idx, sval.reshape(-1), (m,), unique=False, buckets=d)


# ------------------------------------------------------------------ capture

_STACK: list = []


@dataclasses.dataclass
class _Record:
    memory: torch.Tensor           # the pool looked up
    locations: Callable            # () -> [N, d] int32, run in backward
    n_buckets: int                 # d for a striped layout, else 0
    loc: torch.Tensor | None = None
    grad: torch.Tensor | None = None


class _CaptureLookup(torch.autograd.Function):
    """Forward: the normal lookup.  Backward: the record's locations paired
    with the incoming gradient; no gradient for the pool."""

    @staticmethod
    def forward(ctx, memory, record, lookup):
        ctx.record = record
        return lookup()

    @staticmethod
    def backward(ctx, g):
        r = ctx.record
        r.loc = r.locations()
        r.grad = g.contiguous()
        return None, None, None


class SparseCapture:
    """The lookups of one forward/backward pass, in forward call order."""

    def __init__(self):
        self.records: list[_Record] = []

    def lookup(self, memory: torch.Tensor, lookup: Callable,
               locations: Callable, n_buckets: int = 0) -> torch.Tensor:
        """``lookup() -> [N, d]`` run now; ``locations() -> [N, d]`` run in
        backward, when the lookup's gradient arrives."""
        rec = _Record(memory, locations, n_buckets)
        self.records.append(rec)
        return _CaptureLookup.apply(memory, rec, lookup)

    def grads(self, named_params: dict) -> dict:
        """-> {name: SparseGrad} for every pool a lookup read and the loss
        reached; the records are released."""
        out = {}
        for name, p in named_params.items():
            recs = [r for r in self.records
                    if r.memory is p and r.grad is not None]
            if not recs:
                continue
            nbs = {r.n_buckets for r in recs}
            nb = nbs.pop() if len(nbs) == 1 else 0
            if nb and p.dim() == 1 and all(r.loc.dim() == 2
                                           and r.loc.shape[1] == nb
                                           for r in recs):
                loc = torch.cat([r.loc for r in recs], dim=0)
                vals = torch.cat([r.grad.reshape(-1, nb) for r in recs],
                                 dim=0)
                out[name] = from_bucketed_locations(loc, vals,
                                                    tuple(p.shape))
            else:
                loc = torch.cat([r.loc.reshape(-1) for r in recs])
                vals = torch.cat([r.grad.reshape(-1) for r in recs])
                out[name] = from_locations(loc, vals, tuple(p.shape))
        self.records.clear()
        return out


@contextlib.contextmanager
def capture():
    """Route memory lookups through a :class:`SparseCapture` while active."""
    cap = SparseCapture()
    _STACK.append(cap)
    try:
        yield cap
    finally:
        _STACK.pop()


def active() -> SparseCapture | None:
    """The innermost active capture, or None (normal mode)."""
    return _STACK[-1] if _STACK else None


def has_memory(named_params: dict) -> bool:
    """Does any parameter name end in ``memory`` (a pool)?"""
    return any(n.split(".")[-1] == "memory" for n in named_params)


# ------------------------------------------------------- sparse update + apply

def _leaf_sparse_update(algo: str, g: SparseGrad, states: tuple, **hyper):
    from repro_torch.kernels.sparse_update.ops import sparse_update
    u, new_states = sparse_update(algo, g.indices, g.values, states,
                                  unique=g.unique, **hyper)
    return g.map_values(lambda _: u), new_states


def sparse_apply(p: torch.Tensor, u: SparseGrad) -> None:
    """``apply_updates`` for one sparse leaf: an O(K) scatter-add into ``p``
    in place (sentinel entries dropped; non-head entries carry 0)."""
    idx, vals = u.indices, u.values.to(p.dtype)
    if u.unique:
        keep = idx < u.sentinel
        idx, vals = idx[keep], vals[keep]
    p.index_add_(0, idx.long(), vals)


def adagrad_leaf(g, acc, p=None, *, lr, eps=1e-10):
    """One leaf of Adagrad: a SparseGrad through the sparse kernel, a dense
    gradient by the dense formula; ``acc`` is updated in place."""
    if is_sparse(g):
        u, (acc,) = _leaf_sparse_update("adagrad", g, (acc,), lr=lr, eps=eps)
        return u, acc
    from repro_torch.kernels.sparse_update.ref import ieee_sqrt
    acc.add_(torch.square(g.to(torch.float32)))
    return (-lr * g / (ieee_sqrt(acc) + eps)).to(g.dtype), acc


def sparse_adagrad(lr: float, eps: float = 1e-10,
                   initial_acc: float = 0.0) -> Optimizer:
    """Lazy Adagrad: the dense ``optimizers.adagrad`` contract (``initial_acc``
    and ``eps``), with an O(K) step on a SparseGrad leaf."""
    return adagrad(lr, eps, initial_acc)
