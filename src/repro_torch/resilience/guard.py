"""Non-finite step guard: skip a poisoned step without touching state (port
of ``repro.resilience.guard``).

``make_step`` builds the train step the Trainer runs.  With ``guard=True``
the step checks that the loss and every floating gradient leaf (dense
tensors and ``SparseGrad`` values alike, bucketed ``unique=False`` streams
included) are finite and magnitude-bounded.  Each leaf reduces to one
device bool, the bools and the loss's to one verdict, and the host reads
that verdict once, after the backward and before any optimizer state is
touched: a bad step then calls neither the optimizer's ``update`` nor
``apply_updates``, so parameters and every optimizer moment stay
bit-unchanged -- the step is *skipped*, not clamped (the reference decides
inside the jit, ``lax.cond`` with an identity branch).  The caller reads
``ok`` to count the skip and decide on rollback.

The magnitude bound (``max_abs_grad``) exists because overflow-scale
gradients (the ``huge_grad`` fault, 1e30) are finite: they pass an isfinite
check, then produce inf the moment the optimizer squares them.

The fault multiplier scales the gradients only on a step a fault fires
(the reference multiplies by 1.0 otherwise, a bitwise identity), so a
clean guarded step is bit-identical to an unguarded one without a pass
over the pool's gradient values.

Under an installed mesh (``repro_torch.dist``) with the batch split over
'data' (``split=True``: each rank holds its share) the step is the
reference's single SPMD step spelled per rank: the loss that is
differentiated is the rank's share of the global mean (its local mean over
D), the dense gradients and the loss are summed over 'data' in rank order
(one all-gather, ``collectives.fold_sum``: every replica applies the same
bits), and each pool's SparseGrad is built from the whole global batch's
records, gathered over 'data' in batch order (data index d holds rows
``[d * B / D, (d + 1) * B / D)``), which is the reference's stream.  The
blocks of a model stored for training under the mesh that are split over
'data' (ZeRO-3) are not folded: their gathers' backward summed them.  Under
any mesh of more than one rank the guard's verdict is agreed over the world
(a bad leaf on any rank skips the step on all), as the reference's one
``lax.cond``.
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable

import torch

from repro_torch.optim import sparse as sparse_lib
from repro_torch.optim.optimizers import Optimizer, apply_updates

# Default gradient magnitude bound: generous enough that no real training
# signal trips it (f32 tops out ~3.4e38), tight enough that an overflow-bound
# gradient is caught before the optimizer squares it into inf.
MAX_ABS_GRAD = 1e18


def guard_enabled() -> bool:
    """``REPRO_GUARD_STEP`` gate (default on)."""
    return os.environ.get("REPRO_GUARD_STEP", "1").lower() not in (
        "0", "false", "off", "no")


def leaf_finite(x, max_abs: float | None = None) -> torch.Tensor | None:
    """0-dim device bool for one gradient leaf; None for non-float leaves.
    One pass, no temporary: ``aminmax`` propagates NaN to both ends, so the
    leaf is finite and bounded iff its min and max are."""
    v = x.values if sparse_lib.is_sparse(x) else x
    if not isinstance(v, torch.Tensor) or not v.is_floating_point():
        return None
    if v.numel() == 0:
        return torch.ones((), dtype=torch.bool, device=v.device)
    lo, hi = torch.aminmax(v)
    if max_abs is None:
        return torch.isfinite(lo) & torch.isfinite(hi)
    return (lo >= -max_abs) & (hi <= max_abs)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def all_finite(tree, max_abs: float | None = None) -> torch.Tensor:
    """0-dim bool: every floating leaf of ``tree`` (a dict of gradients by
    name) is finite and bounded; on the leaves' device, nothing read."""
    checks = [c for c in (leaf_finite(x, max_abs) for x in _leaves(tree))
              if c is not None]
    if not checks:
        return torch.tensor(True)
    ok = checks[0]
    for c in checks[1:]:
        ok = ok & c
    return ok


def touched_indices(grads) -> torch.Tensor:
    """Concatenated slot indices of every ``SparseGrad`` leaf (sentinels
    included): the dirty-set feed for delta checkpoints, exactly the slots
    this step's sparse update can write."""
    idx = [x.indices.reshape(-1) for x in _leaves(grads)
           if sparse_lib.is_sparse(x)]
    if not idx:
        return torch.zeros((0,), dtype=torch.int32)
    return torch.cat(idx)


def scale_grads(grads: dict, scale: float) -> dict:
    """Every floating gradient leaf (SparseGrad values too) times the fault
    scale."""
    def one(x):
        if sparse_lib.is_sparse(x):
            return x.map_values(lambda v: v * scale)
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x * scale
        return x
    return {k: one(v) for k, v in grads.items()}


def _data_reduce(grads: dict, loss: torch.Tensor, mesh,
                 params: dict | None = None) -> tuple:
    """The dense gradients and the loss summed over 'data' in rank order,
    one collective per dtype (every leaf of a dtype and, for float32, the
    loss ride in one buffer); -> (grads, the loss's mean over 'data').
    A block stored over 'data' (``sharding.stored_spec``: a ZeRO-3 leaf of
    a model stored for training under the mesh) is left as it is: its
    gather's backward already summed it over 'data'."""
    from repro_torch.dist import collectives as col
    from repro_torch.dist.sharding import spec_axes, stored_spec

    def over_data(k) -> bool:
        spec = stored_spec(params[k]) if params is not None else None
        return spec is not None and any(
            "data" in spec_axes(spec, i) for i in range(len(spec)))
    names = [k for k, g in grads.items()
             if isinstance(g, torch.Tensor) and not over_data(k)]
    leaves = [grads[k] for k in names] + [loss.reshape(1)]
    out = dict(grads)
    # in the leaves' order: a set of dtypes iterates in another order in
    # each process, and every rank must issue the same collectives
    for dtype in dict.fromkeys(x.dtype for x in leaves):
        idx = [i for i, x in enumerate(leaves) if x.dtype == dtype]
        buf = col.fold_sum(torch.cat([leaves[i].reshape(-1) for i in idx]),
                           mesh, "data")
        for i, part in zip(idx, torch.split(buf, [leaves[i].numel()
                                                  for i in idx])):
            if i < len(names):
                out[names[i]] = part.reshape(leaves[i].shape)
            else:
                loss = part.reshape(()) / mesh.data
    return out, loss


def _data_gather(mesh):
    """``x [n, ...]`` -> the 'data' ranks' ``x`` concatenated in rank order
    (the global batch's rows, for a batch split over 'data')."""
    from repro_torch.dist import collectives as col
    return lambda x: col.all_gather(x, mesh, "data").reshape(
        (-1,) + tuple(x.shape[1:]))


def make_step(loss_fn: Callable, optimizer: Optimizer, *,
              sparse_grads: bool = False, guard: bool = True,
              max_abs_grad: float | None = MAX_ABS_GRAD,
              report_touched: bool = False,
              on_phase: Callable[[str], None] | None = None):
    """Build the train step.

    Returns ``step(model, params, opt_state, batch, fault_scale=1.0,
    split=False) -> (opt_state, loss, ok, grads_ok)`` (``split``: the
    batch is this rank's share of a batch split over the installed mesh's
    'data' axis): ``params`` (the model's named
    parameters) are updated in place, the new optimizer state is returned,
    ``loss`` is a device scalar, and ``ok`` / ``grads_ok`` are the guard's
    verdict as host bools (``ok`` False: nothing was updated; ``grads_ok``
    tells a bad gradient from a bad loss).  With ``guard=False`` the step is
    the unguarded path (no checks) and both are True.
    ``report_touched=True`` appends the step's ``touched_indices`` (reported
    for skipped steps too; the trainer marks them only when ``ok``).
    ``on_phase(name)`` is called as the step starts ("start") and as each
    phase ends ("forward", "backward", "sparse_grad", "guard" when guarded,
    "update", "apply"), e.g. to record CUDA events."""
    mark = on_phase or (lambda name: None)

    def step(model, params: dict, opt_state, batch, fault_scale=1.0,
             split: bool = False):
        from repro_torch.dist.context import current_mesh
        from repro_torch.dist.sharding import stored_spec
        mesh = current_mesh()
        D = mesh.data if split else 1
        if mesh is not None and mesh.data > 1 and not split and any(
                stored_spec(p) is not None for p in params.values()):
            raise ValueError(
                "a model stored for training under a mesh takes its 'data' "
                "share of the batch: the 'data' axis must divide it")
        mark("start")
        for p in params.values():
            p.grad = None
        scope = (sparse_lib.capture() if sparse_grads
                 else contextlib.nullcontext())
        with scope as cap:
            loss, _ = loss_fn(model, batch)
            mark("forward")
            (loss / D if D > 1 else loss).backward()
            mark("backward")
        grads = {k: p.grad for k, p in params.items() if p.grad is not None}
        loss = loss.detach()
        if D > 1:
            grads, loss = _data_reduce(grads, loss, mesh, params)
        if cap is not None:
            grads.update(cap.grads(
                params, gather=_data_gather(mesh) if D > 1 else None))
        mark("sparse_grad")
        if fault_scale != 1.0:
            grads = scale_grads(grads, fault_scale)
        touched = (touched_indices(grads),) if report_touched else ()
        ok = grads_ok = True
        if guard:
            g_ok = all_finite(grads, max_abs_grad).to(loss.device)
            verdict = torch.stack([torch.isfinite(loss).all() & g_ok, g_ok])
            if mesh is not None and mesh.world > 1:
                from repro_torch.dist import collectives as col
                bad = col.world_max((~verdict).to(torch.int32), mesh)
                verdict = bad == 0
            # the one host read of the verdict, before any state is touched
            ok, grads_ok = verdict.tolist()
            mark("guard")
        if ok:
            updates, opt_state = optimizer.update(grads, opt_state, params)
            mark("update")
            apply_updates(params, updates)
            mark("apply")
        return (opt_state, loss, ok, grads_ok) + touched

    return step
