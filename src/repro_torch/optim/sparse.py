"""Sparse gradients for the memory pool (port of ``repro.optim.sparse``).

A batch touches at most ``B * L * d`` of the pool's ``m`` slots, yet a
dense step materializes an ``[m]`` gradient and runs the optimizer over all
of it.  This module replaces both with O(K) work.

``SparseGrad``
    The gradient of one pool as sorted ``indices [K]`` and ``values [K, ...]``,
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
    backward computes what the lookup touched (the ``[N, d]`` locations: the
    fused locations kernel on the card, ``scheme.locations`` on the CPU; or,
    for a row-aligned scheme whose budget tiles into rows, the ``[N]`` pool
    rows, ``scheme.sparse_row_ids``), keeps it with the incoming ``[N, d]``
    gradient in forward call order, and returns no gradient for the pool.
    So the pool's ``.grad`` stays ``None`` and no ``[m]`` gradient is ever
    allocated.  After ``backward()``, ``SparseCapture.grads`` builds one
    ``SparseGrad`` per pool by the reference's rule (``sparse.py:394-426``):
    row mode (one index per pool row, ``[K, d]`` values, ``dense_shape
    (m // d, d)``) for row records, bucketed when the scheme declares stripe
    buckets (striped lma), flat dedup otherwise.

``sparse_sgd`` / ``sparse_adagrad`` / ``sparse_rowwise_adam``
    Lazy optimizers: a pool leaf's update is one pass over the K entries
    (``repro_torch/kernels/sparse_update``), in the SparseGrad's own layout
    (the flat ``[m]`` states are viewed as ``[m // d, d]`` for a row-mode
    gradient).  Untouched slots keep their moments and parameters bit for
    bit; Adam's bias correction uses the global step.  Dense leaves get the
    same formulas applied everywhere.

Under a mesh (``repro_torch.dist``) a pool parameter is this rank's
``[m / P]`` slab.  Its SparseGrad still has the pool's global shape and the
whole global batch's entries (the same on every rank: with the batch split
over 'data', ``grads(gather=...)`` first concatenates the 'data' ranks'
records in batch order), and its leaf update and apply go through
``sharded_sparse_update`` / ``sharded_sparse_apply`` on the slab states, as
the reference's ``_model_mesh`` routes them.

Gate: ``REPRO_SPARSE_GRADS`` (default on; ``=0`` keeps the dense path as the
oracle), as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.sparse_update.ref import div, ieee_sqrt, row_mean
from repro_torch.optim.optimizers import Optimizer, _adam, adagrad, sgd


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
    locations: Callable            # () -> [N, d] slots or [N] rows, run in
    #                                backward
    n_buckets: int                 # d for a striped layout, else 0
    row_width: int = 0             # d when locations gives [N] pool rows
    slots: int = 0                 # the pool's global slots (a slab's too)
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
               locations: Callable, n_buckets: int = 0,
               row_width: int = 0, slots: int | None = None) -> torch.Tensor:
        """``lookup() -> [N, d]`` run now; ``locations()`` run in backward,
        when the lookup's gradient arrives: ``[N, d]`` element slots, or
        with ``row_width=d`` the ``[N]`` pool rows of a row-aligned scheme
        (the reference's ``record_rows``).  ``slots`` is the pool's global
        size when ``memory`` is a rank's slab of it."""
        rec = _Record(memory, locations, n_buckets, row_width,
                      int(memory.shape[0]) if slots is None else slots)
        self.records.append(rec)
        return _CaptureLookup.apply(memory, rec, lookup)

    def grads(self, named_params: dict, gather: Callable | None = None
              ) -> dict:
        """-> {name: SparseGrad} for every pool a lookup read and the loss
        reached; the records are released.  ``gather(x [n, ...])``, when
        given, replaces each record's locations and gradient before the
        build (the 'data' ranks' rows in batch order, for a batch split over
        'data')."""
        out = {}
        for name, p in named_params.items():
            recs = [r for r in self.records
                    if r.memory is p and r.grad is not None]
            if not recs:
                continue
            if gather is not None:
                for r in recs:
                    r.loc, r.grad = gather(r.loc), gather(r.grad)
            rws = {r.row_width for r in recs}
            if len(rws) != 1:
                raise ValueError(f"{name}: one memory pool mixes row- and "
                                 "element-level sparse records")
            (rw,) = rws
            m = recs[0].slots
            nbs = {r.n_buckets for r in recs}
            nb = nbs.pop() if len(nbs) == 1 else 0
            if rw:                                  # row-aligned pool
                rows = torch.cat([r.loc.reshape(-1) for r in recs])
                vals = torch.cat([r.grad.reshape(-1, rw) for r in recs])
                out[name] = from_locations(rows, vals, (m // rw, rw))
            elif nb and p.dim() == 1 and all(r.loc.dim() == 2
                                           and r.loc.shape[1] == nb
                                           for r in recs):
                loc = torch.cat([r.loc for r in recs], dim=0)
                vals = torch.cat([r.grad.reshape(-1, nb) for r in recs],
                                 dim=0)
                out[name] = from_bucketed_locations(loc, vals, (m,))
            else:
                loc = torch.cat([r.loc.reshape(-1) for r in recs])
                vals = torch.cat([r.grad.reshape(-1) for r in recs])
                out[name] = from_locations(loc, vals, (m,))
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

def _pool_view(arr: torch.Tensor, shape: tuple) -> torch.Tensor:
    """A flat ``[m]`` pool or state as the SparseGrad's ``(rows, d)`` layout:
    a view, so an in-place update lands in ``arr``."""
    shape = tuple(shape)
    if tuple(arr.shape) == shape:
        return arr
    if arr.numel() != math.prod(shape):
        raise ValueError(f"a {tuple(arr.shape)} state does not view as "
                         f"{shape}")
    return arr.view(shape)


def _model_mesh(arr: torch.Tensor, dense_shape: tuple):
    """The installed mesh when ``arr`` is a rank's slab of a parameter (or
    state) of ``dense_shape`` (a 'model' axis P > 1 that divides its rows),
    else None."""
    from repro_torch.dist.context import current_mesh
    mesh = current_mesh()
    if mesh is None or mesh.model <= 1 or dense_shape[0] % mesh.model:
        return None
    return mesh if arr.numel() * mesh.model == math.prod(dense_shape) \
        else None


def _slab_shape(dense_shape: tuple, mesh) -> tuple:
    return (dense_shape[0] // mesh.model,) + tuple(dense_shape[1:])


def _leaf_sparse_update(algo: str, g: SparseGrad, states: tuple, **hyper):
    """One sparse leaf through the kernel (a rank's slab: the sharded
    update), the states (updated in place) viewed in the SparseGrad's
    layout.  -> (update SparseGrad, states)."""
    from repro_torch.kernels.sparse_update.ops import sparse_update
    mesh = _model_mesh(states[0], g.dense_shape) if states else None
    if mesh is not None:
        from repro_torch.dist.sharded_memory import sharded_sparse_update
        shape = _slab_shape(g.dense_shape, mesh)
        views = tuple(_pool_view(s, shape) for s in states)
        idx, u, _ = sharded_sparse_update(algo, g.indices, g.values, views,
                                          hyper, mesh, unique=g.unique,
                                          buckets=g.buckets)
        return dataclasses.replace(g, indices=idx, values=u), states
    views = tuple(_pool_view(s, g.dense_shape) for s in states)
    u, _ = sparse_update(algo, g.indices, g.values, views, unique=g.unique,
                         **hyper)
    return g.map_values(lambda _: u), states


def sparse_apply(p: torch.Tensor, u: SparseGrad) -> None:
    """``apply_updates`` for one sparse leaf: an O(K) scatter-add into ``p``
    in place, in the SparseGrad's layout (sentinel entries dropped; non-head
    entries carry 0); into a rank's slab, the masked sharded apply."""
    mesh = _model_mesh(p, u.dense_shape)
    if mesh is not None:
        from repro_torch.dist.sharded_memory import sharded_sparse_apply
        sharded_sparse_apply(_pool_view(p, _slab_shape(u.dense_shape, mesh)),
                             u.indices, u.values, mesh)
        return
    idx, vals = u.indices, u.values.to(p.dtype)
    if u.unique:
        keep = idx < u.sentinel
        idx, vals = idx[keep], vals[keep]
    _pool_view(p, u.dense_shape).index_add_(0, idx.long(), vals)


# -------------------------------------------------- leaf update entry points
# (shared by the sparse optimizers below and the dense optimizers of
# optimizers.py, as in the reference)

def sgd_leaf(g, mo, p=None, *, lr, momentum=0.0):
    """One leaf of SGD: ``new = momentum * mo + g; u = -lr * new``; a
    SparseGrad through the sparse kernel (lazy), ``mo`` updated in place."""
    if is_sparse(g):
        states = () if mo is None or momentum == 0.0 else (mo,)
        u, _ = _leaf_sparse_update("sgd", g, states, lr=lr,
                                   momentum=momentum)
        return u, mo
    if momentum == 0.0:
        return -lr * g, mo
    mo.mul_(momentum).add_(g)
    return -lr * mo, mo


def adagrad_leaf(g, acc, p=None, *, lr, eps=1e-10):
    """One leaf of Adagrad: a SparseGrad through the sparse kernel, a dense
    gradient by the dense formula; ``acc`` is updated in place."""
    if is_sparse(g):
        u, (acc,) = _leaf_sparse_update("adagrad", g, (acc,), lr=lr, eps=eps)
        return u, acc
    acc.add_(torch.square(g.to(torch.float32)))
    return (-lr * g / (ieee_sqrt(acc) + eps)).to(g.dtype), acc


# elements past which a dense leaf's Adam update is taken a slice of rows at
# a time (``adam_leaf``)
ADAM_SLICE = 1 << 26


def adam_leaf(g, mu, nu, p=None, *, lr, b1=0.9, b2=0.999, bc1=1.0, bc2=1.0,
              eps=1e-8, weight_decay=0.0):
    """One leaf of Adam, ``mu``/``nu`` updated in place.  A SparseGrad is
    lazy (SparseAdam semantics): the kernel moves only the touched slots,
    and decoupled weight decay is lazy too, ``lr * weight_decay * p`` taken
    off the touched slots' updates only (once per duplicate run).  A dense
    gradient gets the same formulas everywhere, with a row-wise second
    moment when ``nu`` is 1-D against a 2-D or wider gradient; a dense
    leaf past ``ADAM_SLICE`` elements (with an elementwise ``nu``) is
    updated a slice of rows at a time, to the same bits."""
    if is_sparse(g):
        u, _ = _leaf_sparse_update("adam", g, (mu, nu), lr=lr, b1=b1, b2=b2,
                                   bc1=bc1, bc2=bc2, eps=eps)
        if weight_decay and p is not None:
            # u's indices: the SparseGrad's, or a rank's slab-aligned slice
            # of them; a rank's slab reads only the slots it owns (the
            # others' updates are masked off by the sharded apply)
            idx = u.indices
            mesh = _model_mesh(p, g.dense_shape)
            if mesh is not None:
                from repro_torch.dist.sharded_memory import _slab_mask
                pv = _pool_view(p, _slab_shape(g.dense_shape, mesh))
                local, _, keep = _slab_mask(idx, pv.shape[0], mesh)
            else:
                pv = _pool_view(p, g.dense_shape)
                n = pv.shape[0]
                local = torch.clamp(idx, max=n - 1).long()
                keep = idx < n
            rows = pv[local].to(torch.float32)
            if not g.unique:
                keep = keep & torch.cat([
                    torch.ones(1, dtype=torch.bool, device=keep.device),
                    idx[1:] != idx[:-1]])
            keep = keep.reshape((-1,) + (1,) * (u.values.dim() - 1))
            u = u.map_values(lambda v: v - torch.where(
                keep, lr * weight_decay * rows, 0))
        return u, mu, nu
    hyper = dict(lr=lr, b1=b1, b2=b2, bc1=bc1, bc2=bc2, eps=eps,
                 weight_decay=weight_decay)
    n = g.numel()
    if nu.shape != g.shape or n <= ADAM_SLICE or g.dim() == 0 \
            or g.shape[0] < 2:
        return _adam_dense(g, mu, nu, p, **hyper), mu, nu
    # a large leaf a slice of rows at a time: the formulas are elementwise,
    # so the bits are the same, and the float32 and float64 temporaries
    # (about 32 bytes an element) are a slice's, not the leaf's
    u = torch.empty_like(g)
    step = max(1, ADAM_SLICE // (n // g.shape[0]))
    for lo in range(0, g.shape[0], step):
        rows = slice(lo, lo + step)
        u[rows] = _adam_dense(g[rows], mu[rows], nu[rows],
                              None if p is None else p[rows], **hyper)
    return u, mu, nu


def _adam_dense(g, mu, nu, p, *, lr, b1, b2, bc1, bc2, eps, weight_decay):
    """Adam's dense formulas on one leaf (or a slice of its rows), ``mu``
    and ``nu`` updated in place; -> the update in g's dtype."""
    gf = g.to(torch.float32)
    mu.mul_(b1).add_((1 - b1) * gf)
    v2 = gf * gf
    if nu.dim() == 1 and g.dim() > 1:                # row-wise second moment
        nu.mul_(b2).add_((1 - b2) * row_mean(v2.reshape(v2.shape[0], -1)))
        nu_b = nu.reshape(nu.shape + (1,) * (g.dim() - 1))
    else:
        nu.mul_(b2).add_((1 - b2) * v2)
        nu_b = nu
    u = -lr * div(mu, bc1) / (ieee_sqrt(div(nu_b, bc2)) + eps)
    if weight_decay and p is not None:
        u = u - lr * weight_decay * p.to(torch.float32)
    return u.to(g.dtype)


# --------------------------------------------------------- sparse optimizers

def sparse_sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """Lazy momentum SGD: the dense ``optimizers.sgd`` contract, with an
    O(K) step on a SparseGrad leaf whose untouched slots keep their
    momentum (the reference's ``sparse_sgd`` is the same code)."""
    return sgd(lr, momentum)


def sparse_adagrad(lr: float, eps: float = 1e-10,
                   initial_acc: float = 0.0) -> Optimizer:
    """Lazy Adagrad: the dense ``optimizers.adagrad`` contract (``initial_acc``
    and ``eps``), with an O(K) step on a SparseGrad leaf."""
    return adagrad(lr, eps, initial_acc)


class RowwiseAdamState(NamedTuple):
    step: int                      # the global step, 0 before the first
    mu: object
    nu: object


def sparse_rowwise_adam(lr: float, b1: float = 0.9, b2: float = 0.999,
                        eps: float = 1e-8) -> Optimizer:
    """Lazy Adam with a row-wise second moment (one nu per leading index: for
    the flat pool each slot is its own row, i.e. elementwise): ``adam``'s
    update without weight decay.  Bias correction uses the global step;
    untouched rows keep stale moments."""
    return _adam(lr, b1, b2, eps, 0.0, RowwiseAdamState,
                 lambda x: (x.shape[0],) if x.dim() > 1 else x.shape)
