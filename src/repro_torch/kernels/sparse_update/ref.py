"""Plain PyTorch version of the sparse optimizer update (SGD, Adagrad, Adam).

A copy of ``repro/kernels/sparse_update/ref.py`` operation for operation, so
on the CPU it is bit-identical to the reference's jnp version run op by op.
One contract for every algorithm: sorted ``indices [K]``, either unique with
a sentinel tail (``unique=True``: sentinel = ``state.shape[0]``, values 0
there) or with duplicate runs (``unique=False``, the bucketed stream, folded
here first).  Two layouts: flat states ``[m]`` with values ``[K]``, or
``[rows, d]`` states with values ``[K, d]`` (the row-mode SparseGrad); Adam's
second moment may also be row-wise, ``nu [rows]`` against ``[K, d]``.

-> the ``[K, ...]`` update values (0 at sentinel and non-head positions) and
the states, which are updated IN PLACE with the reference's add-of-delta
value (``state[safe] += where(keep, new - old, 0)``: a stored moment is
``old + (new - old)``, which is not always ``new``), written once at each
kept slot, so untouched slots keep their bits; the reference returns new
arrays instead.  The write is a store, not PyTorch's ``index_add_``: on the
card that is an atomic add, which flushes a subnormal result to zero (a
second moment of a gradient near 1e-18 is one).

Every product, sum, quotient and root is rounded on its own, as the
reference's ops are when run one at a time.  (Compiled under ``jax.jit``,
XLA on the CPU contracts some ``a * b + c`` into fused multiply-adds, in some
fusions and not others, so a jitted reference can differ from this by an
ulp; the CUDA kernels follow this version.)
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


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a Python number ``c``, an IEEE division on every device
    (PyTorch's CUDA kernel multiplies by the reciprocal of a host scalar
    instead, which can be an ulp off)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """``[K, d] -> [K]`` mean over d in one fixed order, which the row-wise
    Adam kernel follows: zero-pad d to a power of two, add the right half to
    the left half until one column is left, divide by d.  (The reference's
    ``jnp.mean`` sums in XLA's order, so it agrees to about 1e-7 relative,
    not bitwise.)"""
    d = int(x.shape[1])
    width = 1 << max(d - 1, 0).bit_length()
    s = torch.nn.functional.pad(x, (0, width - d))
    while width > 1:
        width //= 2
        s = s[:, :width] + s[:, width:]
    return div(s[:, 0], d)


def _keep(indices, m: int, values):
    k = indices < m
    return k.reshape(k.shape + (1,) * (values.dim() - 1))


def _maybe_fold(indices, values, keep, unique):
    """Fold duplicate runs and head-mask ``keep``, so every run's sum lands
    once and every state delta and update is 0 at duplicate positions."""
    if unique:
        return values, keep
    head, values = fold_duplicates(indices, values)
    return values, keep & head.reshape(head.shape + (1,) * (keep.dim() - 1))


def _store(state, safe, keep, old, delta) -> None:
    """``state[safe] = old + delta`` at the kept entries (each kept slot
    appears once: sentinels and non-heads are dropped)."""
    k = keep.reshape(keep.shape[0])
    state[safe[k]] = (old + delta)[k]


def _gather(state, safe, trailing: int):
    g = state[safe]
    if state.dim() == 1 and trailing:           # row-wise state vs [K, d]
        g = g.reshape(g.shape + (1,) * trailing)
    return g


def sparse_sgd_ref(indices, values, mo=None, *, lr, momentum=0.0,
                   unique=True):
    """-> (update_values, (mo,) or ()): ``new = momentum * mo + s;
    u = -lr * new``.  Without momentum there is no state: ``-lr * values``
    (a scatter-add sums duplicates exactly, no fold needed)."""
    if momentum == 0.0 or mo is None:
        return -lr * values, ()
    m = mo.shape[0]
    safe = torch.clamp(indices, max=m - 1).long()
    keep = _keep(indices, m, values)
    values, keep = _maybe_fold(indices, values, keep, unique)
    old = _gather(mo, safe, 0)
    new = momentum * old + values
    _store(mo, safe, keep, old, new - old)
    return torch.where(keep, -lr * new, 0), (mo,)


def sparse_adagrad_ref(indices, values, acc, *, lr, eps=1e-10, unique=True):
    """-> (update_values, (acc,)): dense-Adagrad math per touched slot,
    ``acc += v * v; u = -lr * v / (sqrt(acc) + eps)``."""
    m = acc.shape[0]
    safe = torch.clamp(indices, max=m - 1).long()
    keep = _keep(indices, m, values)
    values, keep = _maybe_fold(indices, values, keep, unique)
    vf = values.to(torch.float32)
    sq = vf * vf
    old = _gather(acc, safe, 0)
    a = old + sq
    _store(acc, safe, keep, old, sq)
    u = -lr * vf / (ieee_sqrt(a) + eps)
    return torch.where(keep, u, 0).to(values.dtype), (acc,)


def sparse_adam_ref(indices, values, mu, nu, *, lr, b1=0.9, b2=0.999,
                    bc1=1.0, bc2=1.0, eps=1e-8, unique=True):
    """Lazy Adam, with a row-wise second moment when ``nu`` is 1-D against
    ``[K, d]`` values (``nu`` takes ``row_mean(s * s)``), elementwise
    otherwise.  ``bc1``/``bc2`` are the global-step bias corrections
    ``1 - b ** step`` as float32 values, computed by the caller."""
    m = mu.shape[0]
    trailing = values.dim() - 1
    safe = torch.clamp(indices, max=m - 1).long()
    keep = _keep(indices, m, values)
    values, keep = _maybe_fold(indices, values, keep, unique)
    keep_row = keep.reshape(keep.shape[0]) if trailing else keep
    vf = values.to(torch.float32)
    mu_old = _gather(mu, safe, trailing)
    mu_new = b1 * mu_old + (1 - b1) * vf
    v2 = vf * vf
    if nu.dim() == 1 and trailing:               # row-wise second moment
        nu_old_row = nu[safe]
        nu_new_row = b2 * nu_old_row + (1 - b2) * row_mean(v2)
        _store(nu, safe, keep_row, nu_old_row, nu_new_row - nu_old_row)
        nu_new = nu_new_row.reshape(nu_new_row.shape + (1,) * trailing)
    else:
        nu_old = _gather(nu, safe, 0)
        nu_new = b2 * nu_old + (1 - b2) * v2
        _store(nu, safe, keep, nu_old, nu_new - nu_old)
    _store(mu, safe, keep, mu_old, mu_new - mu_old)
    u = -lr * div(mu_new, bc1) / (ieee_sqrt(div(nu_new, bc2)) + eps)
    return torch.where(keep, u, 0).to(values.dtype), (mu, nu)
